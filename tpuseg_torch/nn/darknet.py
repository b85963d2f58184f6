"""DarkNet-53 (port of ``tpuseg/nn/darknet.py``; yolo.jittor YOLOv3).

A stem conv (32) then five stages of [a stride-2 downsample conv, N
residual blocks], N = (1, 2, 8, 8, 4), channels (64, 128, 256, 512, 1024).
A residual block is a 1x1 conv to c/2 then a 3x3 conv to c, added to its
input. Each conv is followed by BatchNorm (eps 1e-5) and LeakyReLU(0.1).

The modules are named after the JAX package's param tree (``stem``,
``stage{i}.down``, ``stage{i}.blocks.{j}.conv1``/``conv2``, each with its
``conv`` and ``bn``), so that ``weights/darknet_io.py`` walks them in
darknet's cfg order and the JAX npz params map onto them key for key.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))
LEAKY_SLOPE = 0.1
BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose eval mode is the JAX ``batch_norm_inference``'s
    folding (scale = weight * rsqrt(var + eps), then x * scale + (bias -
    mean * scale)), so that the port rounds as its reference does. Train
    mode is torch's: the batch's statistics, the running ones updated with
    momentum 0.1 and the unbiased variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        bias = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + bias[:, None, None]


class ConvBNLeaky(nn.Module):
    """conv (no bias) -> BatchNorm -> LeakyReLU(0.1); ``padding`` defaults
    to kernel // 2."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int | None = None):
        super().__init__()
        pad = kernel // 2 if padding is None else padding
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, bias=False)
        self.bn = BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)), LEAKY_SLOPE)


class ResBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = ConvBNLeaky(ch, ch // 2, 1)
        self.conv2 = ConvBNLeaky(ch // 2, ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.conv1(x))


class Stage(nn.Module):
    def __init__(self, cin: int, ch: int, nblocks: int):
        super().__init__()
        self.down = ConvBNLeaky(cin, ch, 3, stride=2)
        self.blocks = nn.ModuleList(ResBlock(ch) for _ in range(nblocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down(x)
        for blk in self.blocks:
            x = blk(x)
        return x


class DarkNet53(nn.Module):
    """x [B, 3, H, W] -> {"c3": /8, "c4": /16, "c5": /32}."""

    def __init__(self):
        super().__init__()
        self.stem = ConvBNLeaky(3, 32, 3)
        cin = 32
        for si, (ch, nblocks) in enumerate(STAGES):
            setattr(self, f"stage{si}", Stage(cin, ch, nblocks))
            cin = ch

    def forward(self, x: torch.Tensor) -> dict:
        x = self.stem(x)
        feats = {}
        for si in range(len(STAGES)):
            x = getattr(self, f"stage{si}")(x)
            if si >= 2:
                feats[f"c{si + 1}"] = x
        return feats

    def layers(self):
        """The conv-BN layers in darknet's cfg order."""
        yield self.stem
        for si in range(len(STAGES)):
            stage = getattr(self, f"stage{si}")
            yield stage.down
            for blk in stage.blocks:
                yield blk.conv1
                yield blk.conv2
