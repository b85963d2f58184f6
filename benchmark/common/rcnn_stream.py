"""What the stream cells of the port's Mask R-CNN predictor share
(``MaskRCNNPredictor.run_on_bgr_image``, maskrcnn-benchmark's COCODemo
entry point): the class layer scaled and its biases set by the reference's
calibration on the cell's first frames, one RGB frame a request handed over
as the BGR image the predictor takes, and the harness's span of the
predictor's device pipeline (``forward``, synchronised at its end in the
traced run only)."""
from __future__ import annotations

CALIBRATION_FRAMES = 8
CLS = "roi_heads.box.predictor.cls_score"

# the harness's spans of a traced run: name -> (predictor method,
# synchronise at its end)
STREAM_SPANS = {"forward": ("forward", True)}


def calibrate(state: dict, class_calibration, sizes: dict, frames,
              dev) -> dict:
    """``state`` with the class layer scaled and its biases set as
    ``class_calibration`` (the reference's) finds on the first frames."""
    scale, bias = class_calibration(sizes, state,
                                    frames[:CALIBRATION_FRAMES], dev)
    state[CLS + ".weight"] *= scale
    state[CLS + ".bias"] = bias.to(state[CLS + ".bias"].device)
    return state


def request(pred, img):
    """One uint8 RGB frame through the per-image entry point -> its
    detections."""
    return pred.run_on_bgr_image(img[:, :, ::-1])


def flops_per_request(pred, img) -> float:
    """Model FLOPs of one request (preprocess, forward, paste), counted by
    ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        request(pred, img)
    return float(counter.get_total_flops())
