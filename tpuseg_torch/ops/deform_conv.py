"""Modulated deformable convolution v2, YOLACT++'s DCNv2 (port of
``tpuseg/ops/deform_conv.py``).

A regular conv predicts per-position offsets and modulation; the
deformable conv samples its k x k taps at the offset positions (bilinear,
zero outside the map) and contracts them with the weight:

    cols[b, y, x, (tap, cin)] = m_tap * sample(x, p_tap + offset_tap)
    out = cols @ W[(tap, cin), cout]

The sampling is :func:`tpuseg_torch.ops.sampling.sample_points` (the CUDA
kernel ``csrc/dcn_sample.cu`` for CUDA tensors); the contraction is a
``torch.matmul``, as the JAX package leaves its einsum to XLA. Tensors are
NCHW; the TPU-only machinery of the JAX module (windows, escape budget,
dense fallback) has no counterpart here.
"""
from __future__ import annotations

import torch
from torch import nn

from tpuseg_torch.ops.sampling import sample_points


def dcn_sample_coords(offsets: torch.Tensor, mask: torch.Tensor,
                      kernel: int = 3, stride: int = 1, padding: int = 1,
                      dilation: int = 1) -> tuple:
    """The sampling points of a deformable conv: offsets [B, 2kk, Ho, Wo]
    ((dy, dx) interleaved per tap t = i*k + j), mask [B, kk, Ho, Wo] ->
    rows ``sy``, columns ``sx`` and modulation ``m``, each [B, Ho*Wo*kk]
    f32 in (oy, ox, tap) order. Tap t of output (oy, ox) samples row
    ``(oy*stride - padding + i*dilation) + dy``, and the column likewise,
    as ``deform_conv.py:225-233`` computes it."""
    b, _, ho, wo = offsets.shape
    k, kk = kernel, kernel * kernel
    dev = offsets.device
    oy = torch.arange(ho, dtype=torch.float32, device=dev) * stride - padding
    ox = torch.arange(wo, dtype=torch.float32, device=dev) * stride - padding
    taps = torch.arange(k, dtype=torch.float32, device=dev) * dilation
    tap_y, tap_x = taps.repeat_interleave(k), taps.repeat(k)
    off = offsets.float().permute(0, 2, 3, 1).reshape(b, ho, wo, kk, 2)
    sy = (oy[None, :, None, None] + tap_y) + off[..., 0]  # [B, Ho, Wo, kk]
    sx = (ox[None, None, :, None] + tap_x) + off[..., 1]
    m = mask.float().permute(0, 2, 3, 1)
    return sy.reshape(b, -1), sx.reshape(b, -1), m.reshape(b, -1)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor | None = None,
                  kernel: int = 3, stride: int = 1, padding: int = 1,
                  dilation: int = 1) -> torch.Tensor:
    """x [B, Cin, H, W]; offsets [B, 2kk, Ho, Wo], (dy, dx) interleaved per
    tap t = i*k + j; mask [B, kk, Ho, Wo] (already sigmoided); weight
    [Cout, Cin, k, k]; bias [Cout] or None -> [B, Cout, Ho, Wo] in
    ``x.dtype`` (channels-last storage). The sampled columns [B, Ho*Wo,
    kk*Cin] are tap-major, as the weight's rows."""
    b, cin = x.shape[:2]
    ho, wo = offsets.shape[2:]
    kk = kernel * kernel
    cols = sample_points(x, *dcn_sample_coords(offsets, mask, kernel, stride,
                                               padding, dilation))
    wmat = weight.permute(2, 3, 1, 0).reshape(kk * cin, -1)  # tap-major rows
    out = torch.matmul(cols.reshape(b * ho * wo, kk * cin),
                       wmat.to(cols.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.to(x.dtype).reshape(b, ho, wo, -1).permute(0, 3, 1, 2)


class ModulatedDeformConv2d(nn.Module):
    """DCNv2 layer (``dcn_block``, ``deform_conv.py:292-308``) with upstream
    DCNv2's attributes: ``weight``, ``bias`` and ``conv_offset_mask``, a
    3*kk-channel conv whose first 2*kk channels are the offsets and whose
    last kk are the modulation's logits."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.dilation = padding, dilation
        kk = kernel_size * kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.conv_offset_mask = nn.Conv2d(in_channels, 3 * kk, kernel_size,
                                          stride=stride, padding=padding,
                                          dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kk = self.kernel_size ** 2
        om = self.conv_offset_mask(x)
        return deform_conv2d(x, om[:, :2 * kk], torch.sigmoid(om[:, 2 * kk:]),
                             self.weight, self.bias, self.kernel_size,
                             self.stride, self.padding, self.dilation)
