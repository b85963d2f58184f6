"""YOLACT++ R-50-FPN's stream cells: the port's predictor with the weights
from the seed, the class gate calibrated on the cell's frames by the
reference, and the per-image entry point that the stream window
(``windows/stream.py``) drives, ``YolactPredictor.predict_images([img])``."""
from __future__ import annotations

import torch
from tpuseg_torch.engine.yolact_engine import YolactPredictor
from tpuseg_torch.models import yolact as Y

from benchmark.common import weights as W
from benchmark.configs import yolactpp_r50 as C
from benchmark.reference import yolactpp_r50 as reference

CALIBRATION_FRAMES = 8
CONF_BIAS = "prediction_layers.0.conf_layer.bias"

# the harness's spans of a traced run: name -> (predictor method,
# synchronise at its end)
STREAM_SPANS = {"forward": ("run_batch", True)}


def serve_state(sizes: dict, seed: int, dev, frames) -> dict:
    """The weights from the seed, the background logit shifted as the
    reference's ``gate_shift`` finds on the first frames."""
    with torch.device("meta"):
        shell = Y.Yolact(C.model_config(sizes))
    sd = W.synthetic_state_dict(shell, seed, dev, C.weight_rule)
    shift = reference.gate_shift(sizes, sd, frames[:CALIBRATION_FRAMES], dev)
    sd[CONF_BIAS].view(-1, sizes["num_classes"])[:, 0] += shift
    return sd


def make_predictor(sizes: dict, state: dict, dev, dtype=None):
    return YolactPredictor(C.model_config(sizes), state_dict=state,
                           dtype=dtype or torch.float32, device=dev)


def request(pred, img):
    """One frame through the per-image entry point -> its detections."""
    return pred.predict_images([img])[0]


def flops_per_request(pred, img) -> float:
    """Model FLOPs of one request's device pipeline (preprocess, forward,
    detect), counted by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        pred.run_batch(img[None])
    return float(counter.get_total_flops())
