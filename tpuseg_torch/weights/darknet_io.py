"""Darknet ``.weights`` reader for YOLOv3 (the port's copy of
``tpuseg/weights/darknet_io.py``).

The original darknet release (yolov3.weights, darknet53.conv.74) is a flat
binary: a header of three int32 (the version) and the images seen (int64
from version 0.2 on, else int32), then per conv layer in yolov3.cfg order
  with BatchNorm:    its bias (beta), weight (gamma), running mean,
                     running variance, then the conv weights [out, in, kh, kw]
  without BatchNorm: the conv bias, then the conv weights.
The readers walk the port's modules in that order
(``nn/darknet.py::DarkNet53.layers``, ``models/yolov3.py::YoloV3.layers``)
and fill them in place.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


class _Reader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            header = np.fromfile(f, np.int32, 3)
            self.version = tuple(header)
            if header[0] * 10 + header[1] >= 2:
                np.fromfile(f, np.int64, 1)  # seen
            else:
                np.fromfile(f, np.int32, 1)
            self.data = np.fromfile(f, np.float32)
        self.pos = 0

    def take(self, n: int) -> np.ndarray:
        out = self.data[self.pos:self.pos + n]
        assert len(out) == n, "darknet weights file exhausted early"
        self.pos += n
        return out

    @property
    def remaining(self) -> int:
        return len(self.data) - self.pos


def _copy(r: _Reader, t: torch.Tensor) -> None:
    t.copy_(torch.from_numpy(r.take(t.numel()).reshape(t.shape)))


def _fill_conv_bn(r: _Reader, layer: nn.Module) -> None:
    """A ConvBNLeaky: beta, gamma, running mean, running var, weights."""
    for t in (layer.bn.bias, layer.bn.weight, layer.bn.running_mean,
              layer.bn.running_var, layer.conv.weight):
        _copy(r, t)


def _fill_conv_bias(r: _Reader, conv: nn.Conv2d) -> None:
    _copy(r, conv.bias)
    _copy(r, conv.weight)


def load_darknet53_backbone(path: str, model: nn.Module) -> nn.Module:
    """Fill ``model.backbone`` (a DarkNet-53) from darknet53.conv.74 (the
    ImageNet-pretrained backbone); the rest of the file is not read."""
    r = _Reader(path)
    with torch.no_grad():
        for layer in model.backbone.layers():
            _fill_conv_bn(r, layer)
    return model


def load_yolov3_weights(path: str, model: nn.Module) -> nn.Module:
    """Fill a :class:`~tpuseg_torch.models.yolov3.YoloV3` from a full
    yolov3.weights file, in cfg order; every float of the file is used."""
    r = _Reader(path)
    with torch.no_grad():
        for layer, has_bn in model.layers():
            (_fill_conv_bn if has_bn else _fill_conv_bias)(r, layer)
    assert r.remaining == 0, (f"{r.remaining} floats left over — layer order "
                              "mismatch")
    return model
