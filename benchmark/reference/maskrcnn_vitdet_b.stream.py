"""The plain reference of ViTDet-B Mask R-CNN's stream cells, as a user of
the predictor receives each frame: the 1024 test resize of RGB normalised
by ImageNet's mean and std on a 1024x1024 canvas, the model, Mask R-CNN's
post-processing and paste (``frozen/maskrcnn_infer.py``), in float32 with
TF32 off. It imports nothing of the port."""
from __future__ import annotations

import torch

from benchmark.reference import maskrcnn_vitdet_b as R
from benchmark.reference.exact import float32_exact
from benchmark.reference.frozen import maskrcnn_infer as I


def requests(sizes: dict, state: dict, frames: list, dev):
    """Each frame (uint8 RGB [h, w, 3]) -> its detections, one at a time."""
    with float32_exact(), torch.no_grad():
        model = R.build(sizes, state, dev)
        yield from I.requests(model, frames, sizes["min_size_test"],
                              sizes["max_size_test"], dev, R.rgb_norm(sizes))
