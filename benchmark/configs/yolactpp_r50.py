"""YOLACT++ R-50-FPN (dbolya/yolact ``yolact_plus_resnet50_config``): the
port's model config at the sizes of ``yolactpp_r50.json`` and the weight
scheme from the seed, for every kind of cell of the configuration
(``yolactpp_r50.<window>.py`` holds each kind's entry points)."""
from __future__ import annotations

import dataclasses

from tpuseg_torch.configs.presets import yolact_model_config
from tpuseg_torch.models import yolact as Y

from benchmark.common import weights as W
from benchmark.reference import yolactpp_r50 as reference

# the inference scheme of chip_smoke.py::synthetic_yolact_state_dict
OFFSET_SCALE = 2.0  # DCN offset convs: offsets of a few pixels
CONF_SCALE = 3.0  # the class-logit layer


def model_config(sizes: dict) -> Y.YolactConfig:
    """The port's preset, field for field the reference's config."""
    cfg = yolact_model_config(sizes["preset"])
    if dataclasses.asdict(cfg) != dataclasses.asdict(
            reference.model_config(sizes)):
        raise ValueError("the port's preset and the reference's differ")
    return cfg


def weight_rule(name: str, shape: tuple) -> tuple:
    if name.endswith("running_var") or (name.endswith(".weight")
                                        and len(shape) == 1):
        return ("uniform", 0.7, 1.3)
    scale = 0.02  # biases
    if name.endswith(".weight"):
        scale = W.fan_scale(shape)
        if "conv_offset_mask" in name:
            scale *= OFFSET_SCALE
        elif name.endswith("conf_layer.weight"):
            scale *= CONF_SCALE
    elif name.endswith("running_mean"):
        scale = 0.05
    return ("normal", scale)
