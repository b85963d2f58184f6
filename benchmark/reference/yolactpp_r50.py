"""The plain reference of YOLACT++ R-50-FPN (dbolya/yolact
``yolact_plus_resnet50_config``): its model config from the configuration's
sizes, the model from a state dict, and the class gate's calibration of the
benchmark's random weights (after ``chip_smoke.py::calibrate_yolact_gate``),
for every kind of cell (``yolactpp_r50.<window>.py`` holds each kind's
reference); float32 with TF32 off, through ``frozen/`` (copies of the
port's plain code: the plain DCN sampler, no kernel). It imports nothing
of the port."""
from __future__ import annotations

import numpy as np
import torch

from .exact import float32_exact
from .frozen import yolact as Y
from .frozen.preprocess import yolact_preprocess


def model_config(sizes: dict) -> Y.YolactConfig:
    steps = sizes["scale_steps"]
    return Y.YolactConfig(
        backbone=sizes["backbone"], img_size=sizes["img_size"],
        num_classes=sizes["num_classes"], mask_dim=sizes["mask_dim"],
        fpn_channels=sizes["fpn_channels"],
        aspect_ratios=tuple(sizes["aspect_ratios"]),
        scales=tuple(tuple(s * 2 ** (j / float(steps)) for j in range(steps))
                     for s in sizes["scales"]),
        use_square_anchors=sizes["use_square_anchors"],
        conf_thresh=sizes["conf_thresh"], nms_iou_thresh=sizes["nms_thresh"],
        nms_top_k=sizes["nms_top_k"],
        max_num_detections=sizes["max_num_detections"],
        dcn_backbone=sizes["dcn_backbone"], use_maskiou=sizes["use_maskiou"])


def build(sizes: dict, state: dict, dev) -> Y.Yolact:
    model = Y.build_model(model_config(sizes))
    model.load_state_dict(state, strict=True)
    return model.to(dev).eval()


def gate_shift(sizes: dict, state: dict, frames: np.ndarray, dev,
               want=(10, 500)) -> float:
    """The least shift of the background logit (a grid of 0.05) after
    which every frame has ``want[0]``..``want[1]`` priors whose best class
    score passes ``conf_thresh`` (the smoke's inference calibration, whose
    margin is 0: with 57 744 priors one always lies near the gate)."""
    cfg = model_config(sizes)
    with float32_exact(), torch.no_grad():
        model = build(sizes, state, dev)
        x = yolact_preprocess(torch.from_numpy(frames).to(dev), cfg.img_size)
        conf = model(x)["conf"].double()
        del model
    fg_max = conf[..., 1:].amax(-1)
    fg_lse = torch.logsumexp(conf[..., 1:], -1)
    for shift in np.arange(0.0, 80.0, 0.05):
        best = torch.exp(fg_max - torch.logaddexp(conf[..., 0] + shift,
                                                  fg_lse))
        n = (best > cfg.conf_thresh).sum(1)
        if bool(((n >= want[0]) & (n <= want[1])).all()):
            return float(shift)
    raise AssertionError(f"no background shift gives {want} priors a frame")
