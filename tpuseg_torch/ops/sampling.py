"""FPN multi-level RoIAlign (port of ``tpuseg/ops/sampling.py::
multilevel_roi_align`` and ``ops/pallas/roi_align_pl.py::
clamp_levels_to_window``).

Features are NCHW, as everywhere in the port; pooled outputs are
[N, C, P, P], the layout upstream's box and mask heads consume.
:func:`multilevel_roi_align` dispatches: the CUDA kernel
(``csrc/roi_align.cu``) for CUDA tensors, :func:`multilevel_roi_align_plain`
for CPU tensors (see :mod:`tpuseg_torch.kernels`).
"""
from __future__ import annotations

import torch

from tpuseg_torch import kernels

_CHUNK = 256  # rois per gather of the plain RoIAlign (bounds its memory)


def _window_bounds(level_hw, itemsize: int, rows: int, span: int):
    """Per-level window bounds of the TPU kernel, and its column alignment,
    which depends on the feature dtype (8 for f32, 16 for bf16)."""
    align = 32 // itemsize
    shapes_pad = [(h, w + (-w) % align) for h, w in level_hw]
    n_lv = len(level_hw)
    lv_rows_b = tuple(rows if li == n_lv - 1 else min(32, rows)
                      for li in range(n_lv))
    lv_span_b = tuple(span if li == n_lv - 1 else min(32 + align, span)
                      for li in range(n_lv))
    return align, shapes_pad, lv_rows_b, lv_span_b


def clamp_levels_to_window(feats, boxes: torch.Tensor, levels: torch.Tensor,
                           strides=(4, 8, 16, 32), rows: int = 44,
                           span: int = 64) -> torch.Tensor:
    """Move a box to a coarser level when its extent plus bilinear halo
    would not fit that level's TPU DMA window.

    The reference applies this on every path, so the port applies it by
    default to pool the same levels (it moves only high-aspect boxes).
    ``feats`` are the NCHW levels: H and W are read from dims 2 and 3 and
    the window alignment from the feature dtype's itemsize.
    """
    level_hw = [(f.shape[2], f.shape[3]) for f in feats]
    n_lv = len(feats)
    align, shapes_pad, lv_rows_b, lv_span_b = _window_bounds(
        level_hw, feats[0].element_size(), rows, span)
    fits = []
    for li in range(n_lv):
        h_l, w_true = level_hw[li]
        w_pad = shapes_pad[li][1]
        rl = min(rows, h_l, lv_rows_b[li])
        sl = min(span, w_pad, lv_span_b[li])
        scale = 1.0 / strides[li]
        x1 = boxes[:, 0].float() * scale
        y1 = boxes[:, 1].float() * scale
        x2e = x1 + (boxes[:, 2].float() * scale - x1).clamp(min=1.0)
        y2e = y1 + (boxes[:, 3].float() * scale - y1).clamp(min=1.0)
        r0 = (torch.floor(y1).long() - 1).clamp(0, max(h_l - rl, 0))
        c0 = (torch.floor(x1).long() - 1).clamp(0, max(w_pad - sl, 0))
        c0 = (c0 // align) * align
        rmax = (torch.floor(y2e).long() + 1).clamp(max=h_l - 1)
        cmax = (torch.floor(x2e).long() + 1).clamp(max=w_true - 1)
        fits.append((rmax - r0 + 1 <= rl) & (cmax - c0 + 1 <= sl))
    fits = torch.stack(fits, dim=1)  # [N, L]
    li = torch.arange(n_lv, device=boxes.device)
    cand = torch.where(fits & (li[None, :] >= levels[:, None].long()),
                       li[None, :], n_lv)
    return cand.min(dim=1).values.clamp(max=n_lv - 1).to(torch.int32)


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on every device. On CUDA, PyTorch turns
    division by a Python scalar into multiplication by its rounded
    reciprocal, which moves sample points by an ulp against the kernel's
    (and the reference's) true division; a divisor tensor on the same device
    keeps the division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def multilevel_roi_align_plain(feats, boxes: torch.Tensor,
                               batch_idx: torch.Tensor, levels: torch.Tensor,
                               output_size: int = 7, sampling_ratio: int = 2,
                               strides=(4, 8, 16, 32)) -> torch.Tensor:
    """Plain RoIAlign: each box pooled from its level, ROIAlign_cuda border
    rules, aligned=False, roi w/h >= 1, the mean of S x S samples per bin.
    One gather from the concatenated pyramid, _CHUNK rois at a time;
    sums in f32, the output in the feature dtype. -> [N, C, P, P].

    The sums run in a fixed order, which the kernel repeats: each sample
    is ((w00 v00 + w01 v01) + w10 v10) + w11 v11, the samples of a bin are
    added in (iy, ix) order and divided by S*S once.
    """
    b, c = feats[0].shape[:2]
    n = boxes.shape[0]
    p, s = output_size, sampling_ratio
    dev, dt = boxes.device, boxes.dtype
    shapes = [(f.shape[2], f.shape[3]) for f in feats]
    flat = torch.cat([f.permute(0, 2, 3, 1).reshape(b, -1, c) for f in feats],
                     dim=1)  # [B, sum(H_l*W_l), C]
    total = flat.shape[1]
    flat = flat.reshape(b * total, c)
    offs, acc = [], 0
    for h, w in shapes:
        offs.append(acc)
        acc += h * w
    lv = levels.long()
    lvl_h = torch.tensor([h for h, _ in shapes], dtype=dt, device=dev)[lv]
    lvl_w = torch.tensor([w for _, w in shapes], dtype=dt, device=dev)[lv]
    lvl_off = torch.tensor(offs, dtype=torch.long, device=dev)[lv]
    lvl_scale = torch.tensor([1.0 / st for st in strides], dtype=dt,
                             device=dev)[lv]

    x1 = boxes[:, 0] * lvl_scale
    y1 = boxes[:, 1] * lvl_scale
    roi_w = (boxes[:, 2] * lvl_scale - x1).clamp(min=1.0)
    roi_h = (boxes[:, 3] * lvl_scale - y1).clamp(min=1.0)
    grid = _true_div(torch.arange(p * s, dtype=dt, device=dev) + 0.5, s)
    ys = y1[:, None] + grid[None, :] * _true_div(roi_h, p)[:, None]  # [N, PS]
    xs = x1[:, None] + grid[None, :] * _true_div(roi_w, p)[:, None]
    base = batch_idx.long() * total + lvl_off

    out = []
    for i in range(0, n, _CHUNK):
        sl = slice(i, i + _CHUNK)
        yy = ys[sl, :, None].expand(-1, p * s, p * s)
        xx = xs[sl, None, :].expand(-1, p * s, p * s)
        h3 = lvl_h[sl, None, None]
        w3 = lvl_w[sl, None, None]
        oob = (yy < -1.0) | (yy > h3) | (xx < -1.0) | (xx > w3)
        y = torch.minimum(yy.clamp(min=0.0), h3 - 1)
        x = torch.minimum(xx.clamp(min=0.0), w3 - 1)
        y0 = torch.floor(y)
        x0 = torch.floor(x)
        y1i = torch.minimum(y0 + 1, h3 - 1)
        x1i = torch.minimum(x0 + 1, w3 - 1)
        ly = y - y0
        lx = x - x0
        hy = 1.0 - ly
        hx = 1.0 - lx
        w4 = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx], dim=-1)
        w4 = torch.where(oob[..., None], torch.zeros_like(w4), w4)
        yi = torch.stack([y0, y0, y1i, y1i], dim=-1).long()
        xi = torch.stack([x0, x1i, x0, x1i], dim=-1).long()
        idx4 = base[sl, None, None, None] + yi * w3.long()[..., None] + xi
        prod = flat[idx4].float() * w4[..., None].float()  # [n, PS, PS, 4, C]
        val = ((prod[..., 0, :] + prod[..., 1, :]) + prod[..., 2, :]
               + prod[..., 3, :])
        nc = val.shape[0]
        val = val.reshape(nc, p, s, p, s, c)
        acc = val[:, :, 0, :, 0]
        for k in range(1, s * s):
            acc = acc + val[:, :, k // s, :, k % s]
        out.append(_true_div(acc, s * s).to(feats[0].dtype))
    if not out:
        return flat.new_zeros((0, c, p, p))
    return torch.cat(out).permute(0, 3, 1, 2)


def multilevel_roi_align(feats, boxes: torch.Tensor, batch_idx: torch.Tensor,
                         levels: torch.Tensor, output_size: int = 7,
                         sampling_ratio: int = 2,
                         strides=(4, 8, 16, 32)) -> torch.Tensor:
    """FPN pooler: [B, C, H_l, W_l] levels, boxes [N, 4], batch_idx and
    levels [N] -> [N, C, P, P]. Kernel for CUDA tensors, plain for CPU."""
    if not kernels.use_kernel(feats[0]):
        return multilevel_roi_align_plain(feats, boxes, batch_idx, levels,
                                          output_size, sampling_ratio, strides)
    from tpuseg_torch.kernels import roi_align as K

    return K.multilevel_roi_align(
        [f.contiguous(memory_format=torch.channels_last) for f in feats],
        boxes.float().contiguous(), batch_idx.to(torch.int32).contiguous(),
        levels.to(torch.int32).contiguous(), output_size, sampling_ratio,
        strides)
