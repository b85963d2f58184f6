"""dbolya/yolact checkpoints -> the port's YOLACT state_dict.

The port's module names are upstream's keys (``tpuseg/weights/
yolact_map.py:1-12`` lists them), so an upstream ``.pth`` needs only the key
handling of upstream's own ``Yolact.load_weights``: it drops the
``backbone.layer*`` keys of an ImageNet-initialised torchvision backbone
that are not ``backbone.layers.*``, and the ``fpn.downsample_layers`` past
the two the FPN has.
"""
from __future__ import annotations

from tpuseg_torch.weights.torch_io import flatten_state_dict, load_torch_file

NUM_DOWNSAMPLE = 2


def upstream_keys(state_dict: dict) -> dict:
    """The keys of an upstream checkpoint that a :class:`Yolact` owns."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("backbone.layer") and not k.startswith(
                "backbone.layers"):
            continue
        if (k.startswith("fpn.downsample_layers.")
                and int(k.split(".")[2]) >= NUM_DOWNSAMPLE):
            continue
        out[k] = v
    return out


def load_yolact_weights(path: str) -> dict:
    """Read an upstream YOLACT ``.pth`` (a flat state_dict; any file and
    container that ``weights/torch_io.py`` reads) -> the state_dict for
    ``Yolact.load_state_dict(strict=True)``."""
    return upstream_keys(flatten_state_dict(load_torch_file(path)))
