"""Frozen copy of the port's ``tpuseg_torch/ops/sampling.py`` (plain paths only),
for the benchmark's reference; it imports nothing of the port.

FPN multi-level RoIAlign (port of ``tpuseg/ops/sampling.py::
multilevel_roi_align`` and ``ops/pallas/roi_align_pl.py::
clamp_levels_to_window``) and DCNv2's bilinear point sampler
(:func:`sample_points`: the plain forward, which the stream's reference
runs without gradients).

Features are NCHW, as everywhere in the port; pooled outputs are
[N, C, P, P], the layout upstream's box and mask heads consume.
:func:`multilevel_roi_align` is differentiable in the features and
dispatches: the CUDA kernels (``csrc/roi_align.cu`` forward,
``csrc/roi_align_bwd.cu`` backward) for CUDA tensors, their plain versions
(:func:`multilevel_roi_align_plain`,
:func:`multilevel_roi_align_backward_plain`) for CPU tensors (see
:mod:`tpuseg_torch.kernels`). :func:`roi_align` is the single-level pooler
of the mask targets (its fixed grid), plain torch as the JAX package
leaves it to XLA.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Sums run in f32 for f32 and bf16 features (f64 for f64 ones)."""
    return torch.promote_types(dtype, torch.float32)


class _Lattice(NamedTuple):
    """Per-roi sample lattice over a flattened feature map: the roi's map
    extent ``h``, ``w`` (float, [N]), its first row ``base`` in the
    flattened map ([N] long) and the sample coordinates ``ys``, ``xs``
    ([N, P*S], feature units)."""
    h: torch.Tensor
    w: torch.Tensor
    base: torch.Tensor
    ys: torch.Tensor
    xs: torch.Tensor


def _pyramid_lattice(level_hw, boxes: torch.Tensor, batch_idx: torch.Tensor,
                     levels: torch.Tensor, p: int, s: int, strides):
    """The forward's geometry, shared with its transpose: each box scaled to
    its level, roi w/h >= 1, S x S samples per bin at (i + 0.5) / S of the
    bin. -> (lattice over the [B * sum(H_l W_l), C] flattened pyramid,
    per-level row offsets, rows per image)."""
    dev, dt = boxes.device, boxes.dtype
    offs, total = [], 0
    for h, w in level_hw:
        offs.append(total)
        total += h * w
    lv = levels.long()
    lvl_h = torch.tensor([h for h, _ in level_hw], dtype=dt, device=dev)[lv]
    lvl_w = torch.tensor([w for _, w in level_hw], dtype=dt, device=dev)[lv]
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
    return _Lattice(lvl_h, lvl_w, base, ys, xs), offs, total


def _corners(lat: _Lattice, sl: slice):
    """Bilinear corners of the [n, PS, PS] samples of rois ``sl``: rows
    ``idx4`` [n, PS, PS, 4] of the flattened map and weights ``w4``
    (ROIAlign_cuda border rules: a sample outside [-1, H] x [-1, W] weighs
    0, the rest clamp to the map; corners in the order 00, 01, 10, 11)."""
    ys, xs = lat.ys[sl], lat.xs[sl]
    ps = ys.shape[1]
    yy = ys[:, :, None].expand(-1, ps, ps)
    xx = xs[:, None, :].expand(-1, ps, ps)
    h3 = lat.h[sl, None, None]
    w3 = lat.w[sl, None, None]
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
    idx4 = lat.base[sl, None, None, None] + yi * w3.long()[..., None] + xi
    return idx4, w4


def _pool(flat: torch.Tensor, lat: _Lattice, p: int, s: int,
          out_dtype: torch.dtype) -> torch.Tensor:
    """Mean of the S x S bilinear samples of each bin, _CHUNK rois at a time
    -> [N, C, P, P]. Each sample is ((w00 v00 + w01 v01) + w10 v10) + w11
    v11, the samples of a bin are added in (iy, ix) order and divided by
    S*S once: the order the forward kernel repeats."""
    c = flat.shape[1]
    acc_dt = _acc_dtype(flat.dtype)
    out = []
    for i in range(0, lat.base.shape[0], _CHUNK):
        idx4, w4 = _corners(lat, slice(i, i + _CHUNK))
        prod = flat[idx4].to(acc_dt) * w4[..., None].to(acc_dt)  # [n,PS,PS,4,C]
        val = ((prod[..., 0, :] + prod[..., 1, :]) + prod[..., 2, :]
               + prod[..., 3, :])
        val = val.reshape(val.shape[0], p, s, p, s, c)
        acc = val[:, :, 0, :, 0]
        for k in range(1, s * s):
            acc = acc + val[:, :, k // s, :, k % s]
        out.append(_true_div(acc, s * s).to(out_dtype))
    if not out:
        return flat.new_zeros((0, c, p, p), dtype=out_dtype)
    return torch.cat(out).permute(0, 3, 1, 2)


def multilevel_roi_align_plain(feats, boxes: torch.Tensor,
                               batch_idx: torch.Tensor, levels: torch.Tensor,
                               output_size: int = 7, sampling_ratio: int = 2,
                               strides=(4, 8, 16, 32)) -> torch.Tensor:
    """Plain RoIAlign: each box pooled from its level, ROIAlign_cuda border
    rules, aligned=False, roi w/h >= 1, the mean of S x S samples per bin,
    from one gather over the concatenated pyramid; sums in f32, the output
    in the feature dtype. -> [N, C, P, P]."""
    b, c = feats[0].shape[:2]
    flat = torch.cat([f.permute(0, 2, 3, 1).reshape(b, -1, c) for f in feats],
                     dim=1).reshape(-1, c)  # [B * sum(H_l*W_l), C]
    lat, _, _ = _pyramid_lattice([(f.shape[2], f.shape[3]) for f in feats],
                                 boxes, batch_idx, levels, output_size,
                                 sampling_ratio, strides)
    return _pool(flat, lat, output_size, sampling_ratio, feats[0].dtype)


def multilevel_roi_align_backward_plain(grad_pooled: torch.Tensor,
                                        boxes: torch.Tensor,
                                        batch_idx: torch.Tensor,
                                        levels: torch.Tensor, feat_shapes,
                                        dtype: torch.dtype,
                                        output_size: int = 7,
                                        sampling_ratio: int = 2,
                                        strides=(4, 8, 16, 32)) -> tuple:
    """Plain transpose of :func:`multilevel_roi_align_plain` (the plain
    version of the backward kernel, ``csrc/roi_align_bwd.cu``).

    grad_pooled [N, C, P, P]; ``feat_shapes`` the levels' [B, C, H_l, W_l];
    -> per-level d(feats) in ``dtype``. Each sample adds
    ``grad / (S*S) * w`` into each of its four corners, by an explicit
    ``index_add_`` into the flattened f32 pyramid, rois in order; the sum is
    cast to ``dtype`` once at the end. Boxes get no gradient.
    """
    b, c = feat_shapes[0][:2]
    p, s = output_size, sampling_ratio
    level_hw = [(sh[2], sh[3]) for sh in feat_shapes]
    lat, offs, total = _pyramid_lattice(level_hw, boxes, batch_idx, levels,
                                        p, s, strides)
    acc_dt = _acc_dtype(dtype)
    out = torch.zeros((b * total, c), dtype=acc_dt, device=grad_pooled.device)
    # each sample's share of its bin, [N, P, P, C]
    share = _true_div(grad_pooled.to(acc_dt), s * s).permute(0, 2, 3, 1)
    for i in range(0, lat.base.shape[0], _CHUNK):
        sl = slice(i, i + _CHUNK)
        idx4, w4 = _corners(lat, sl)
        n = idx4.shape[0]
        g = share[sl][:, :, None, :, None, :].expand(n, p, s, p, s, c)
        contrib = (g.reshape(n, p * s, p * s, 1, c)
                   * w4[..., None].to(acc_dt))  # [n, PS, PS, 4, C]
        out.index_add_(0, idx4.reshape(-1), contrib.reshape(-1, c))
    out = out.reshape(b, total, c)
    return tuple(out[:, off:off + h * w].reshape(b, h, w, c)
                 .permute(0, 3, 1, 2).to(dtype)
                 for off, (h, w) in zip(offs, level_hw))


class _MultilevelRoIAlign(torch.autograd.Function):
    """The differentiable pooler: the plain forward and backward. Only the
    features get gradients."""

    @staticmethod
    def forward(ctx, boxes, batch_idx, levels, p, s, strides, *feats):
        ctx.meta = (tuple(tuple(f.shape) for f in feats), feats[0].dtype, p,
                    s, strides)
        ctx.save_for_backward(boxes, batch_idx, levels)
        return multilevel_roi_align_plain(feats, boxes, batch_idx, levels, p,
                                          s, strides)

    @staticmethod
    def backward(ctx, grad):
        boxes, batch_idx, levels = ctx.saved_tensors
        grads = multilevel_roi_align_backward_plain(grad, boxes, batch_idx,
                                                    levels, *ctx.meta)
        return (None,) * 6 + tuple(grads)


def multilevel_roi_align(feats, boxes: torch.Tensor, batch_idx: torch.Tensor,
                         levels: torch.Tensor, output_size: int = 7,
                         sampling_ratio: int = 2,
                         strides=(4, 8, 16, 32)) -> torch.Tensor:
    """FPN pooler: [B, C, H_l, W_l] levels, boxes [N, 4], batch_idx and
    levels [N] -> [N, C, P, P]. Kernel for CUDA tensors, plain for CPU;
    differentiable in the features (boxes get no gradient)."""
    return _MultilevelRoIAlign.apply(boxes, batch_idx, levels, output_size,
                                     sampling_ratio, tuple(strides), *feats)


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              batch_idx: torch.Tensor, output_size: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              aligned: bool = False, group_size: int | None = None
              ) -> torch.Tensor:
    """Single-level RoIAlign (port of ``tpuseg/ops/sampling.py::roi_align``;
    plain torch, as the JAX package leaves it to XLA). features
    [B, C, H, W], rois [N, 4] xyxy image coordinates -> [N, C, P, P].
    ROIAlign_cuda border rules; ``aligned=True`` shifts the roi by half a
    pixel and does not clamp its extent to >= 1.

    A fixed S x S grid per bin (``sampling_ratio > 0``), the samples
    gathered in the order of the RoIAlign kernel; the port's adaptive grid
    and grouped form are left out of this copy.
    """
    if sampling_ratio <= 0 or group_size is not None:
        raise ValueError("the frozen copy holds the fixed grid alone")
    b, c, h, w = features.shape
    p = output_size
    dt, dev = rois.dtype, rois.device
    n = rois.shape[0]
    off = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * spatial_scale - off
    y1 = rois[:, 1] * spatial_scale - off
    roi_w = rois[:, 2] * spatial_scale - off - x1
    roi_h = rois[:, 3] * spatial_scale - off - y1
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    base = batch_idx.long() * (h * w)
    full_h = torch.full((n,), h, dtype=dt, device=dev)
    full_w = torch.full((n,), w, dtype=dt, device=dev)
    bins = torch.arange(p, dtype=dt, device=dev)
    s = sampling_ratio
    slots = torch.arange(s, dtype=dt, device=dev)
    grid = (bins[:, None] + _true_div(slots + 0.5, s)[None, :]).reshape(-1)
    lat = _Lattice(
        full_h, full_w, base,
        y1[:, None] + grid[None, :] * _true_div(roi_h, p)[:, None],
        x1[:, None] + grid[None, :] * _true_div(roi_w, p)[:, None])
    flat = features.permute(0, 2, 3, 1).reshape(b * h * w, c)
    return _pool(flat, lat, p, s, features.dtype)


# ---------------------------------------------------------------------------
# Point sampling with zero padding (DCNv2's sampler)
# ---------------------------------------------------------------------------

# values in one [B, n, C] corner gather of the plain point sampler
_POINT_CHUNK = 1 << 25


def _point_corners(y: torch.Tensor, x: torch.Tensor, h: int, w: int,
                   base: torch.Tensor):
    """The four bilinear corners of points (y, x) [B, n] on [B * H * W]
    flattened maps (image b's first row ``base[b]``), in the order (y0, x0),
    (y0, x1), (y1, x0), (y1, x1) with y0 = floor(y): per corner its rows
    ``idx`` (clamped to the map), weight ``wgt`` (0 outside the map: no
    coordinate clamping), ``inside`` and the weight's derivatives in y and
    x before that masking (the floor rule: one-sided at integers)."""
    y0, x0 = torch.floor(y), torch.floor(x)
    ly, lx = y - y0, x - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    out = []
    for yc, wy, sgn_y in ((y0, hy, -1.0), (y0 + 1, ly, 1.0)):
        for xc, wx, sgn_x in ((x0, hx, -1.0), (x0 + 1, lx, 1.0)):
            inside = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
            idx = (base + yc.clamp(0, h - 1).long() * w
                   + xc.clamp(0, w - 1).long())
            out.append((idx, torch.where(inside, wy * wx, 0.0), inside,
                        sgn_y * wx, sgn_x * wy))
    return out


def _point_setup(feats: torch.Tensor):
    """Flattened channels-last rows [B * H * W, C], each image's first row
    [B, 1], and the samples per chunk that keep a [B, n, C] gather within
    ``_POINT_CHUNK`` values."""
    b, c, h, w = feats.shape
    flat = feats.permute(0, 2, 3, 1).reshape(b * h * w, c)
    base = (torch.arange(b, device=feats.device) * (h * w))[:, None]
    return flat, base, max(1, _POINT_CHUNK // max(b * c, 1))


def sample_points_plain(feats: torch.Tensor, sy: torch.Tensor,
                        sx: torch.Tensor, m: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Bilinear samples with zero padding: feats [B, C, H, W], sample rows
    and columns ``sy``, ``sx`` [B, S] (f32, pixel units), modulation ``m``
    [B, S] or None -> [B, S, C] in the feature dtype, summed in f32.

    The port of the JAX gather path (``_bilinear_corners_zeropad`` +
    ``_gather_weighted``): corners (y0, x0), (y0, x1), (y1, x0), (y1, x1)
    with y0 = floor(y), weights hy*hx, hy*lx, ly*hx, ly*lx, a corner
    outside [0, H-1] x [0, W-1] weighted 0, no coordinate clamping. The
    four products are added in that order, one after another, and the sum
    is multiplied by ``m``: the order the kernel (``csrc/dcn_sample.cu``)
    repeats. Chunked over S so that a corner gather stays within
    ``_POINT_CHUNK`` values."""
    b, c, h, w = feats.shape
    acc_dt = _acc_dtype(feats.dtype)
    flat, base, chunk = _point_setup(feats)
    out = []
    for i in range(0, sy.shape[1], chunk):
        acc = None
        for idx, wgt, _, _, _ in _point_corners(sy[:, i:i + chunk],
                                                sx[:, i:i + chunk], h, w,
                                                base):
            term = flat[idx].to(acc_dt) * wgt.to(acc_dt)[..., None]
            acc = term if acc is None else acc + term
        if m is not None:
            acc = acc * m[:, i:i + chunk, None].to(acc_dt)
        out.append(acc.to(feats.dtype))
    if not out:
        return feats.new_zeros((b, 0, c))
    return torch.cat(out, dim=1)


def sample_points(feats: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                  m: torch.Tensor | None = None) -> torch.Tensor:
    """The port's DCN point sampler: here its plain forward
    (:func:`sample_points_plain`) on every device."""
    return sample_points_plain(feats, sy, sx, m)
