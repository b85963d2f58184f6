"""ViTDet-B Mask R-CNN (detectron2's ``mask_rcnn_vitdet_b_100ep``): the
port's model config at the sizes of ``maskrcnn_vitdet_b.json`` and its
weights from the seed, for every kind of cell of the configuration
(``maskrcnn_vitdet_b.<window>.py`` holds each kind's entry points)."""
from __future__ import annotations

import torch
from tpuseg_torch.models import vitdet as VD

from benchmark.common import weights as W
from benchmark.reference import maskrcnn_vitdet_b as reference

RPN_DELTA_SCALE = 0.1  # the RPN's box deltas: proposals near their anchors
BOX_DELTA_SCALE = 0.05  # the box head's class-specific deltas


def model_config(sizes: dict) -> VD.ViTDetConfig:
    """The port's config at the file's sizes, field for field the
    reference's R-CNN config and backbone sizes."""
    vit = reference.vit_fields(sizes)
    vit["vit_depth"] = vit.pop("depth")
    cfg = VD.ViTDetConfig(
        **reference.config_fields(sizes), **vit,
        pixel_mean=tuple(sizes["pixel_mean"]),
        pixel_std=tuple(sizes["pixel_std"]),
        min_size_test=sizes["min_size_test"],
        max_size_test=sizes["max_size_test"])
    ref = dict(vars(reference.model_config(sizes)), **vit)
    if any(getattr(cfg, k) != v for k, v in ref.items()):
        raise ValueError("the port's config and the reference's differ")
    return cfg


def weight_rule(name: str, shape: tuple) -> tuple:
    if name.endswith("pos_embed"):
        return ("normal", 0.02)
    if ".rel_pos_" in name:
        return ("normal", shape[1] ** -0.5)
    if name.endswith(".weight") and len(shape) == 1:
        return ("uniform", 0.7, 1.3)
    if not name.endswith(".weight"):
        return ("normal", 0.02)  # biases and LayerNorm shifts
    scale = W.fan_scale(shape)
    if name == "rpn.head.bbox_pred.weight":
        scale *= RPN_DELTA_SCALE
    elif name == "roi_heads.box.predictor.bbox_pred.weight":
        scale *= BOX_DELTA_SCALE
    return ("normal", scale)


def initial_state(sizes: dict, seed: int, dev) -> dict:
    """The weights from the seed, on ``dev``."""
    with torch.device("meta"):
        shell = VD.ViTDetMaskRCNN(model_config(sizes))
    return W.synthetic_state_dict(shell, seed, dev, weight_rule)


def make_model(sizes: dict, state: dict, dev) -> VD.ViTDetMaskRCNN:
    with torch.device("meta"):
        model = VD.ViTDetMaskRCNN(model_config(sizes))
    model = model.to_empty(device=dev)
    model.load_state_dict(state, strict=True)
    return model
