"""ViTDet-B Mask R-CNN's stream cells: the port's ``MaskRCNNPredictor``
with ViTDet's config (its 1024 test resize, RGB normalised by ImageNet's
mean and std on the 1024x1024 canvas) and the weights from the seed, the
class layer calibrated on the cell's frames by the reference, and the
per-image entry point that the stream window (``windows/stream.py``)
drives, ``run_on_bgr_image``."""
from __future__ import annotations

import torch
from tpuseg_torch.engine.maskrcnn_engine import MaskRCNNPredictor

from benchmark.common import rcnn_stream as S
from benchmark.configs import maskrcnn_vitdet_b as C
from benchmark.reference import maskrcnn_vitdet_b as reference

STREAM_SPANS = S.STREAM_SPANS
request = S.request
flops_per_request = S.flops_per_request


def serve_state(sizes: dict, seed: int, dev, frames) -> dict:
    sd = C.initial_state(sizes, seed, dev)
    return S.calibrate(sd, reference.class_calibration, sizes, frames, dev)


def make_predictor(sizes: dict, state: dict, dev, dtype=None):
    return MaskRCNNPredictor(model=C.make_model(sizes, state, dev),
                             device=dev, dtype=dtype or torch.float32)
