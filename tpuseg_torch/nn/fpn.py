"""Feature Pyramid Networks (port of ``tpuseg/nn/fpn.py``).

:class:`FPN`, detectron's: 1x1 lateral (``fpn_inner{i}``) and 3x3 output
(``fpn_layer{i}``) convs, nearest top-down upsampling to the lateral's
size, and P6 as a stride-2 1x1 max-pool of P5 (LastLevelMaxPool): outputs
P2..P6. RetinaNet's (``first=2``, laterals over C3..C5 named
``fpn_inner2..4``) takes :class:`LastLevelP6P7` as its ``top_blocks``:
outputs P3..P7.

:class:`YolactFPN`, YOLACT's (``yolact.py::FPN``): laterals over C3..C5,
bilinear top-down upsampling, ReLU after the 3x3 pred convs only, two
stride-2 3x3 downsample convs for P6 and P7. Outputs P3..P7.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LastLevelP6P7(nn.Module):
    """RetinaNet's top block (upstream ``LastLevelP6P7`` on C5): P6 a
    stride-2 3x3 conv of C5, P7 one of relu(P6)."""

    def __init__(self, in_channels: int = 2048, out_channels: int = 256):
        super().__init__()
        self.p6 = nn.Conv2d(in_channels, out_channels, 3, stride=2, padding=1)
        self.p7 = nn.Conv2d(out_channels, out_channels, 3, stride=2,
                            padding=1)

    def forward(self, c5: torch.Tensor) -> list:
        p6 = self.p6(c5)
        return [p6, self.p7(F.relu(p6))]


class FPN(nn.Module):
    """Laterals ``fpn_inner{first..}`` over the last ``len(in_channels)``
    body outputs; after the outputs, P6 by max-pooling the last one, or
    what ``top_blocks`` makes of the last body output."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 first: int = 1, top_blocks: nn.Module | None = None):
        super().__init__()
        self.first = first
        self.num_inputs = len(in_channels)
        for i, c in enumerate(in_channels, start=first):
            self.add_module(f"fpn_inner{i}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"fpn_layer{i}",
                            nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.top_blocks = top_blocks

    def forward(self, feats: list) -> list:
        feats = feats[-self.num_inputs:]
        inner = [getattr(self, f"fpn_inner{i + self.first}")(f)
                 for i, f in enumerate(feats)]
        last = inner[-1]
        tds = [last]
        for lat in reversed(inner[:-1]):
            last = lat + F.interpolate(last, size=lat.shape[-2:],
                                       mode="nearest")
            tds.insert(0, last)
        out = [getattr(self, f"fpn_layer{i + self.first}")(t)
               for i, t in enumerate(tds)]
        if self.top_blocks is None:
            return out + [F.max_pool2d(out[-1], 1, 2)]
        return out + self.top_blocks(feats[-1])


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
    """``backbone.body`` (ResNet) + ``backbone.fpn``: images -> the
    pyramid ([P2..P6], or RetinaNet's [P3..P7])."""

    def __init__(self, body: nn.Module, fpn: FPN):
        super().__init__()
        self.body = body
        self.fpn = fpn

    def forward(self, images: torch.Tensor) -> list:
        return self.fpn(self.body(images))
