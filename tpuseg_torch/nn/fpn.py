"""Feature Pyramid Networks (port of ``tpuseg/nn/fpn.py``).

:class:`FPN`, detectron's: 1x1 lateral (``fpn_inner{i}``) and 3x3 output
(``fpn_layer{i}``) convs, nearest top-down upsampling to the lateral's
size, and P6 as a stride-2 1x1 max-pool of P5 (LastLevelMaxPool). Outputs
P2..P6.

:class:`YolactFPN`, YOLACT's (``yolact.py::FPN``): laterals over C3..C5,
bilinear top-down upsampling, ReLU after the 3x3 pred convs only, two
stride-2 3x3 downsample convs for P6 and P7. Outputs P3..P7.
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


class YolactFPN(nn.Module):
    """Module lists in upstream's order, so its checkpoint keys load as they
    are: ``lat_layers[0]`` reads C5 (the laterals run over the inputs in
    reverse) and ``pred_layers[0]`` is applied to P5."""

    def __init__(self, in_channels=(512, 1024, 2048), out_channels=256):
        super().__init__()
        self.lat_layers = nn.ModuleList(
            nn.Conv2d(c, out_channels, 1) for c in reversed(in_channels))
        self.pred_layers = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, padding=1)
            for _ in in_channels)
        self.downsample_layers = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, stride=2, padding=1)
            for _ in range(2))

    def forward(self, convouts: list) -> list:
        """[C3, C4, C5] -> [P3, P4, P5, P6, P7]. The top-down path upsamples
        with half-pixel bilinear interpolation (35 -> 69 and 18 -> 35 at
        550), as ``jax.image.resize(..., "linear", antialias=False)`` does."""
        n = len(convouts)
        out = [None] * n
        x = None
        for i, lat in enumerate(self.lat_layers):
            j = n - 1 - i
            y = lat(convouts[j])
            if x is not None:
                y = F.interpolate(x, size=y.shape[-2:], mode="bilinear",
                                  align_corners=False) + y
            out[j] = x = y
        for i, pred in enumerate(self.pred_layers):
            j = n - 1 - i
            out[j] = F.relu(pred(out[j]))
        p6 = self.downsample_layers[0](out[-1])
        return out + [p6, self.downsample_layers[1](p6)]


class Backbone(nn.Module):
    """``backbone.body`` (ResNet) + ``backbone.fpn``: images -> [P2..P6]."""

    def __init__(self, body: nn.Module, fpn: FPN):
        super().__init__()
        self.body = body
        self.fpn = fpn

    def forward(self, images: torch.Tensor) -> list:
        return self.fpn(self.body(images))
