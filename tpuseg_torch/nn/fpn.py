"""Feature Pyramid Network, detectron variant (port of
``tpuseg/nn/fpn.py::fpn_forward``).

1x1 lateral (``fpn_inner{i}``) and 3x3 output (``fpn_layer{i}``) convs,
nearest top-down upsampling to the lateral's size, and P6 as a stride-2
1x1 max-pool of P5 (LastLevelMaxPool). Outputs P2..P6.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256):
        super().__init__()
        for i, c in enumerate(in_channels, start=1):
            self.add_module(f"fpn_inner{i}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"fpn_layer{i}",
                            nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, feats: list) -> list:
        inner = [getattr(self, f"fpn_inner{i + 1}")(f)
                 for i, f in enumerate(feats)]
        last = inner[-1]
        tds = [last]
        for lat in reversed(inner[:-1]):
            last = lat + F.interpolate(last, size=lat.shape[-2:],
                                       mode="nearest")
            tds.insert(0, last)
        out = [getattr(self, f"fpn_layer{i + 1}")(t) for i, t in enumerate(tds)]
        out.append(F.max_pool2d(out[-1], 1, 2))
        return out


class Backbone(nn.Module):
    """``backbone.body`` (ResNet) + ``backbone.fpn``: images -> [P2..P6]."""

    def __init__(self, body: nn.Module, fpn: FPN):
        super().__init__()
        self.body = body
        self.fpn = fpn

    def forward(self, images: torch.Tensor) -> list:
        return self.fpn(self.body(images))
