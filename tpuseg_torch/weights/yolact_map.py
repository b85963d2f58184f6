"""dbolya/yolact checkpoints -> the port's YOLACT state_dict.

The port's module names are upstream's keys (``tpuseg/weights/
yolact_map.py:1-12`` lists them), so an upstream ``.pth`` needs only the key
handling of upstream's own ``Yolact.load_weights``: it drops the
``backbone.layer*`` keys of an ImageNet-initialised torchvision backbone
that are not ``backbone.layers.*``, and the ``fpn.downsample_layers`` past
the two the FPN has.

DarkNet-53 is the one exception: the port's YOLACT and YOLOv3 share
``nn/darknet.py``, whose modules carry the JAX tree's names. Upstream's
``DarkNetBackbone`` keys (``tpuseg/weights/yolact_map.py:95-116``) map onto
them one for one: ``backbone._preconv.{conv,bn}`` is ``backbone.stem``,
``backbone.layers.{s}.0`` the stage's ``down`` and
``backbone.layers.{s}.{b + 1}.{0,1}`` block ``b``'s ``conv1`` and
``conv2``.
"""
from __future__ import annotations

import re

from tpuseg_torch.weights.torch_io import flatten_state_dict, load_torch_file

NUM_DOWNSAMPLE = 2
_DARKNET_STEM = "backbone._preconv."
_UPSTREAM_DARKNET = re.compile(
    r"^backbone\.layers\.(\d+)\.(\d+)\.(?:([01])\.)?(conv|bn)\.(.+)$")
_PORT_DARKNET = re.compile(
    r"^backbone\.stage(\d+)\.(?:down|blocks\.(\d+)\.conv([12]))\."
    r"(conv|bn)\.(.+)$")


def _from_upstream_darknet(key: str) -> str:
    if key.startswith(_DARKNET_STEM):
        return "backbone.stem." + key[len(_DARKNET_STEM):]
    m = _UPSTREAM_DARKNET.match(key)
    if not m:
        return key
    s, j, c, mod, rest = m.groups()
    if j == "0":
        return f"backbone.stage{s}.down.{mod}.{rest}"
    return (f"backbone.stage{s}.blocks.{int(j) - 1}.conv{int(c) + 1}."
            f"{mod}.{rest}")


def _to_upstream_darknet(key: str) -> str:
    if key.startswith("backbone.stem."):
        return _DARKNET_STEM + key[len("backbone.stem."):]
    m = _PORT_DARKNET.match(key)
    if not m:
        return key
    s, b, c, mod, rest = m.groups()
    if b is None:
        return f"backbone.layers.{s}.0.{mod}.{rest}"
    return f"backbone.layers.{s}.{int(b) + 1}.{int(c) - 1}.{mod}.{rest}"


def upstream_state_dict(state_dict: dict) -> dict:
    """A port YOLACT's state_dict under upstream's keys (the DarkNet-53
    backbone renamed; a ResNet's keys already are upstream's)."""
    return {_to_upstream_darknet(k): v for k, v in state_dict.items()}


def upstream_keys(state_dict: dict) -> dict:
    """The keys of an upstream checkpoint that a :class:`Yolact` owns,
    DarkNet-53's under the port's names."""
    darknet = any(k.startswith(_DARKNET_STEM) for k in state_dict)
    out = {}
    for k, v in state_dict.items():
        if darknet:
            k = _from_upstream_darknet(k)
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
