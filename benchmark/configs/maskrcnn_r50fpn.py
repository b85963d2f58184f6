"""Mask R-CNN R-50-FPN (maskrcnn-benchmark's e2e_mask_rcnn_R_50_FPN_1x):
the port's model at the sizes of ``maskrcnn_r50fpn.json`` and its weights
from the seed, for every kind of cell of the configuration
(``maskrcnn_r50fpn.<window>.py`` holds each kind's entry points)."""
from __future__ import annotations

import dataclasses

import torch
from tpuseg_torch.models import maskrcnn as M

from benchmark.common import weights as W
from benchmark.reference import maskrcnn_r50fpn as reference

# the weight scheme of chip_smoke.py::synthetic_state_dict
PIXEL_VAR = 75.0 ** 2  # the stem's frozen variance, matched to the pixels'
CLS_SCORE_SCALE = 0.008
SPECIAL = {"rpn.head.cls_logits.weight": 3e-4,
           "rpn.head.bbox_pred.weight": 1e-4}


def model_config(sizes: dict) -> M.MaskRCNNConfig:
    """The port's config at the file's sizes, field for field the
    reference's."""
    cfg = M.MaskRCNNConfig(**reference.config_fields(sizes))
    if dataclasses.asdict(cfg) != dataclasses.asdict(
            reference.model_config(sizes)):
        raise ValueError("the port's config and the reference's differ")
    return cfg


def weight_rule(name: str, shape: tuple) -> tuple:
    if name.endswith("running_var") or (name.endswith(".weight")
                                        and len(shape) == 1):
        return ("uniform", 0.7, 1.3)
    if name in SPECIAL:
        return ("normal", SPECIAL[name])
    if name.endswith(".weight"):
        scale = W.fan_scale(shape)
        if name == "roi_heads.box.predictor.cls_score.weight":
            scale *= CLS_SCORE_SCALE
        elif name == "roi_heads.box.predictor.bbox_pred.weight":
            scale *= 0.05
        return ("normal", scale)
    if name.endswith("running_mean"):
        return ("normal", 0.05)
    return ("normal", 0.02)  # biases


def initial_state(sizes: dict, seed: int, dev) -> dict:
    """The weights from the seed, on ``dev``."""
    with torch.device("meta"):
        shell = M.MaskRCNN(model_config(sizes))
    sd = W.synthetic_state_dict(shell, seed, dev, weight_rule)
    sd["backbone.body.stem.bn1.running_var"] *= PIXEL_VAR
    return sd


def make_model(sizes: dict, state: dict, dev) -> M.MaskRCNN:
    with torch.device("meta"):
        model = M.MaskRCNN(model_config(sizes))
    model = model.to_empty(device=dev)
    model.load_state_dict(state, strict=True)
    return model
