"""ViTDet's plain backbone (Li, Mao, Girshick, He, "Exploring Plain Vision
Transformer Backbones for Object Detection", arXiv:2203.16527; detectron2
``modeling/backbone/vit.py`` and ``SimpleFeaturePyramid``).

:class:`ViT`: a 16x16 stride-16 patch embedding to [B, H, W, C] tokens, a
learned absolute position table made for the pretraining size (a class
entry and 14x14 at 224) resized bicubically to the token grid on every
forward, then pre-LN blocks. A block either attends within windows of
``window_size`` tokens a side (the grid zero-padded after ``norm1`` to a
multiple of the window; the padded tokens take part as keys, unmasked, and
are cut off after ``proj``) or globally over the whole grid. Every block
adds decomposed relative positions to its scores:

    attn = (q * s) k^T + rel_h + rel_w,  s = head_dim ** -0.5
    rel_h[n, h, w, k_h] = sum_c q[n, h, w, c] * R_h[h, k_h, c]
    R_h[i, j] = rel_pos_h[(i - j) + (K_h - 1)]

with the unscaled q, and ``rel_w`` the same along the width. The scores are
formed in the inputs' dtype by explicit matrix products around a softmax
(``torch.matmul`` follows the process's TF32 setting, off by default).

:class:`SimpleFeaturePyramid`: from the one stride-16 map, P2 by two 2x2
stride-2 transposed convs (channel LayerNorm and GELU between), P3 by one,
P4 as it is, P5 by a 2x2 max pool; each then a 1x1 and a 3x3 conv, both
without bias and each followed by a channel LayerNorm; P6 a stride-2 1x1
max pool of P5.

Module paths are detectron2's state_dict keys (``net.blocks.{i}.attn.qkv``,
``simfp_2.4.norm``). The program's spans ``vit.window_attn`` and
``vit.global_attn`` hold each block's attention (q, k, v in, the heads'
output out); ``vit.window_tokens`` and ``vit.window_pad_tokens`` count the
tokens of the padded grids that windowed blocks attend over, and the
padding among them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.utils import timer


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels of an NCHW map (detectron2's
    ``LayerNorm``, eps 1e-6, the biased variance)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight,
                         self.bias, self.eps)
        return y.permute(0, 3, 1, 2)


class ConvNorm(nn.Conv2d):
    """A convolution without bias followed by a channel LayerNorm
    (detectron2's ``Conv2d(..., bias=False, norm=LayerNorm)``)."""

    def __init__(self, cin: int, cout: int, k: int, eps: float = 1e-6):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = ChannelLayerNorm(cout, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


def window_partition(x: torch.Tensor, window: int) -> tuple:
    """[B, H, W, C] -> ([B * nH * nW, window, window, C], padded (Hp, Wp)),
    the grid zero-padded at its bottom and right to a multiple of
    ``window``."""
    b, h, w, c = x.shape
    ph, pw = (-h) % window, (-w) % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    timer.count("vit.window_tokens", b * hp * wp)
    timer.count("vit.window_pad_tokens", b * (hp * wp - h * w))
    x = x.view(b, hp // window, window, wp // window, window, c)
    return (x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c),
            (hp, wp))


def window_unpartition(windows: torch.Tensor, window: int, pad_hw: tuple,
                       hw: tuple) -> torch.Tensor:
    """The inverse of :func:`window_partition`, the padding cut off."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w] if (hp, wp) != (h, w) else x


def gathered_rel_pos(table: torch.Tensor, size: int) -> torch.Tensor:
    """R[i, j] = table[(i - j) + size - 1] -> [size, size, head_dim]; the
    table must have 2 * size - 1 rows (a block's grid or window)."""
    if table.shape[0] != 2 * size - 1:
        raise ValueError(f"a relative-position table of {table.shape[0]} "
                         f"rows for {size} positions: the canvas must be "
                         "the one the backbone was built for")
    i = torch.arange(size, device=table.device)
    return table[i[:, None] - i[None, :] + (size - 1)]


def rel_pos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      table_h: torch.Tensor, table_w: torch.Tensor,
                      hw: tuple, scale: float) -> torch.Tensor:
    """Attention with decomposed relative positions over one grid of
    ``hw`` tokens: q, k, v [N, h*w, c] (N windows x heads) -> [N, h*w, c].
    The relative terms take the unscaled q; they are added in place into
    the [N, h, w, h, w] view of the scores."""
    h, w = hw
    n, _, c = q.shape
    r_q = q.view(n, h, w, c)
    rel_h = torch.einsum("nhwc,hkc->nhwk", r_q, gathered_rel_pos(table_h, h))
    rel_w = torch.einsum("nhwc,wkc->nhwk", r_q, gathered_rel_pos(table_w, w))
    attn = torch.matmul(q * scale, k.transpose(-2, -1))
    grid = attn.view(n, h, w, h, w)
    grid += rel_h[:, :, :, :, None]
    grid += rel_w[:, :, :, None, :]
    return torch.matmul(torch.softmax(attn, dim=-1), v)


class Attention(nn.Module):
    """Multi-head self-attention over a [B, H, W, C] grid with decomposed
    relative positions; ``input_size`` sizes the tables (the window, or
    the whole grid of a global block)."""

    def __init__(self, dim: int, num_heads: int, input_size: tuple,
                 span: str):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  head_dim))
        self.span = span

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        nh = self.num_heads
        qkv = (self.qkv(x).reshape(b, h * w, 3, nh, -1)
               .permute(2, 0, 3, 1, 4).reshape(3, b * nh, h * w, -1))
        q, k, v = qkv.unbind(0)
        with timer.span(self.span):
            out = rel_pos_attention(q, k, v, self.rel_pos_h, self.rel_pos_w,
                                    (h, w), self.scale)
        out = out.view(b, nh, h, w, -1).permute(0, 2, 3, 1, 4)
        return self.proj(out.reshape(b, h, w, -1))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """A pre-LN block; ``window_size`` 0 attends over the whole grid."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window_size: int, grid: tuple, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(
            dim, num_heads, (window_size,) * 2 if window_size else grid,
            "vit.window_attn" if window_size else "vit.global_attn")
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.window_size:
            hw = x.shape[1:3]
            x, pad_hw = window_partition(x, self.window_size)
            x = window_unpartition(self.attn(x), self.window_size, pad_hw, hw)
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).permute(0, 2, 3, 1)  # [B, H, W, C]


def abs_pos(table: torch.Tensor, hw: tuple) -> torch.Tensor:
    """The pretraining position table [1, 1 + S*S, C] without its class
    entry, resized bicubically (half-pixel centres) to ``hw`` ->
    [1, h, w, C]."""
    grid = table[:, 1:]
    s = math.isqrt(grid.shape[1])
    grid = grid.reshape(1, s, s, -1)
    if (s, s) == tuple(hw):
        return grid
    grid = F.interpolate(grid.permute(0, 3, 1, 2), size=tuple(hw),
                         mode="bicubic", align_corners=False)
    return grid.permute(0, 2, 3, 1)


class ViT(nn.Module):
    """The plain ViT of ViTDet: images [B, 3, H, W] -> [B, C, H/16, W/16]
    (no final norm). Blocks ``window_block_indexes`` attend in windows,
    the others globally over the ``img_size // patch_size`` grid."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, window_size: int = 14,
                 window_block_indexes=(0, 1, 3, 4, 6, 7, 9, 10),
                 pretrain_img_size: int = 224, eps: float = 1e-6):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        n_pos = (pretrain_img_size // patch_size) ** 2 + 1
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, embed_dim))
        grid = (img_size // patch_size,) * 2
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  window_size if i in window_block_indexes else 0, grid, eps)
            for i in range(depth))
        self.out_channels = embed_dim

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images)
        x = x + abs_pos(self.pos_embed, x.shape[1:3])
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 3, 1, 2)


class SimpleFeaturePyramid(nn.Module):
    """``net`` (the ViT) -> [P2, P3, P4, P5, P6] of ``out_channels`` at
    strides 4..64 (scale factors 4, 2, 1, 0.5 of the stride-16 map, then
    LastLevelMaxPool)."""

    def __init__(self, net: ViT, out_channels: int = 256,
                 scale_factors=(4.0, 2.0, 1.0, 0.5), eps: float = 1e-6):
        super().__init__()
        self.net = net
        dim = net.out_channels
        self.stages = []
        for scale in scale_factors:
            if scale == 4.0:
                layers = [nn.ConvTranspose2d(dim, dim // 2, 2, stride=2),
                          ChannelLayerNorm(dim // 2, eps), nn.GELU(),
                          nn.ConvTranspose2d(dim // 2, dim // 4, 2, stride=2)]
                cin = dim // 4
            elif scale == 2.0:
                layers = [nn.ConvTranspose2d(dim, dim // 2, 2, stride=2)]
                cin = dim // 2
            elif scale == 1.0:
                layers, cin = [], dim
            elif scale == 0.5:
                layers, cin = [nn.MaxPool2d(2, stride=2)], dim
            else:
                raise ValueError(f"scale factor {scale} is not supported")
            layers += [ConvNorm(cin, out_channels, 1, eps),
                       ConvNorm(out_channels, out_channels, 3, eps)]
            stage = nn.Sequential(*layers)
            self.add_module(f"simfp_{int(math.log2(16 / scale))}", stage)
            self.stages.append(stage)

    def forward(self, images: torch.Tensor) -> list:
        x = self.net(images)
        out = [stage(x) for stage in self.stages]
        return out + [F.max_pool2d(out[-1], 1, 2)]
