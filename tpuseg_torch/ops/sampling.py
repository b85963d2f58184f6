"""FPN multi-level RoIAlign (port of ``tpuseg/ops/sampling.py::
multilevel_roi_align`` and ``ops/pallas/roi_align_pl.py::
clamp_levels_to_window``) and DCNv2's bilinear point sampler
(:func:`sample_points`, differentiable: the kernels ``csrc/dcn_sample.cu``
forward and ``csrc/dcn_sample_bwd.cu`` backward for CUDA tensors,
:func:`sample_points_plain` and :func:`sample_points_backward_plain` for
CPU tensors).

Features are NCHW, as everywhere in the port; pooled outputs are
[N, C, P, P], the layout upstream's box and mask heads consume.
:func:`multilevel_roi_align` is differentiable in the features and
dispatches: the CUDA kernels (``csrc/roi_align.cu`` forward,
``csrc/roi_align_bwd.cu`` backward) for CUDA tensors, their plain versions
(:func:`multilevel_roi_align_plain`,
:func:`multilevel_roi_align_backward_plain`) for CPU tensors (see
:mod:`tpuseg_torch.kernels`). :func:`roi_align` is the single-level pooler
of the mask targets and of the C4 models (its adaptive grid), and
:func:`roi_pool` the max pooler; both plain torch, as the JAX package
leaves them to XLA.
"""
from __future__ import annotations

from typing import NamedTuple

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


def _kernel_forward(feats, boxes, batch_idx, levels, p, s, strides):
    from tpuseg_torch.kernels import roi_align as K

    return K.multilevel_roi_align(
        [f.contiguous(memory_format=torch.channels_last) for f in feats],
        boxes.float().contiguous(), batch_idx.to(torch.int32).contiguous(),
        levels.to(torch.int32).contiguous(), p, s, strides)


def _kernel_backward(grad_pooled, boxes, batch_idx, levels, feat_shapes,
                     dtype, p, s, strides):
    from tpuseg_torch.kernels import roi_align as K

    if not (grad_pooled.is_contiguous() or grad_pooled.is_contiguous(
            memory_format=torch.channels_last)):
        grad_pooled = grad_pooled.contiguous()  # e.g. expanded, stride 0
    return K.multilevel_roi_align_backward(
        grad_pooled, boxes.float().contiguous(),
        batch_idx.to(torch.int32).contiguous(),
        levels.to(torch.int32).contiguous(), feat_shapes, dtype, p, s, strides)


def _backward_on(kernel: bool, grad_pooled, boxes, batch_idx, levels,
                 feat_shapes, dtype, p, s, strides) -> tuple:
    """The one place that picks the backward: the kernel if ``kernel``,
    else :func:`multilevel_roi_align_backward_plain`."""
    back = _kernel_backward if kernel else multilevel_roi_align_backward_plain
    return back(grad_pooled, boxes, batch_idx, levels, feat_shapes, dtype, p,
                s, strides)


def multilevel_roi_align_backward(grad_pooled: torch.Tensor,
                                  boxes: torch.Tensor, batch_idx: torch.Tensor,
                                  levels: torch.Tensor, feat_shapes,
                                  dtype: torch.dtype, output_size: int = 7,
                                  sampling_ratio: int = 2,
                                  strides=(4, 8, 16, 32)) -> tuple:
    """d(feats) of the FPN pooler: the backward kernel for CUDA tensors,
    :func:`multilevel_roi_align_backward_plain` for CPU tensors (see
    :func:`tpuseg_torch.kernels.use_kernel`)."""
    return _backward_on(kernels.use_kernel(grad_pooled), grad_pooled, boxes,
                        batch_idx, levels, feat_shapes, dtype, output_size,
                        sampling_ratio, strides)


class _MultilevelRoIAlign(torch.autograd.Function):
    """The differentiable pooler (``make_differentiable_pooler``,
    ``roi_align_pl.py:466-493``): the forward kernel forward, the backward
    kernel backward (their plain versions on the CPU). Only the features
    get gradients; the path is chosen once, at the forward."""

    @staticmethod
    def forward(ctx, boxes, batch_idx, levels, p, s, strides, *feats):
        ctx.kernel = kernels.use_kernel(feats[0])
        ctx.meta = (tuple(tuple(f.shape) for f in feats), feats[0].dtype, p,
                    s, strides)
        ctx.save_for_backward(boxes, batch_idx, levels)
        if ctx.kernel:
            return _kernel_forward(feats, boxes, batch_idx, levels, p, s,
                                   strides)
        return multilevel_roi_align_plain(feats, boxes, batch_idx, levels, p,
                                          s, strides)

    @staticmethod
    def backward(ctx, grad):
        boxes, batch_idx, levels = ctx.saved_tensors
        grads = _backward_on(ctx.kernel, grad, boxes, batch_idx, levels,
                             *ctx.meta)
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

    ``sampling_ratio > 0`` samples a fixed S x S grid per bin;
    ``sampling_ratio == 0`` is upstream's adaptive grid (the C4 pooler's):
    ``gh = clip(ceil(roi_h / P), 1, s)`` rows (and ``gw`` columns) per bin
    for the static bound ``s = ceil(max(H, W) / P)``, the slots past a
    roi's own grid masked and the bin the sum over ``1 / (gh * gw)``.

    ``group_size=R`` declares that ``batch_idx == repeat(arange(B), R)``
    and takes the separable form ``pooled = Ay F Ax^T`` (:func:`_roi_align_
    matmul`, differentiable in the features), whose memory does not grow
    with the (P s)^2 sample lattice; without it the samples are gathered
    (the fixed grid in the order of the RoIAlign kernel, the adaptive one
    in chunks that bound the gather's memory).
    """
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
    if sampling_ratio > 0 and group_size is None:
        s = sampling_ratio
        slots = torch.arange(s, dtype=dt, device=dev)
        grid = (bins[:, None] + _true_div(slots + 0.5, s)[None, :]).reshape(-1)
        lat = _Lattice(
            full_h, full_w, base,
            y1[:, None] + grid[None, :] * _true_div(roi_h, p)[:, None],
            x1[:, None] + grid[None, :] * _true_div(roi_w, p)[:, None])
        flat = features.permute(0, 2, 3, 1).reshape(b * h * w, c)
        return _pool(flat, lat, p, s, features.dtype)

    if sampling_ratio > 0:
        s = sampling_ratio
        gh = gw = torch.full((n,), s, dtype=dt, device=dev)
    else:
        s = -(-max(h, w) // p)
        gh = torch.ceil(_true_div(roi_h, p)).clamp(1, s)
        gw = torch.ceil(_true_div(roi_w, p)).clamp(1, s)
    # slot i of bin k sits at k + (i + 0.5) / g bin units; slots >= g are
    # masked off
    slots = torch.arange(s, dtype=dt, device=dev)
    gy = bins[None, :, None] + (slots[None, None, :] + 0.5) / gh[:, None, None]
    gx = bins[None, :, None] + (slots[None, None, :] + 0.5) / gw[:, None, None]
    ys = y1[:, None] + gy.reshape(n, p * s) * _true_div(roi_h, p)[:, None]
    xs = x1[:, None] + gx.reshape(n, p * s) * _true_div(roi_w, p)[:, None]
    vy = (slots[None, None, :] < gh[:, None, None]).expand(n, p, s).reshape(
        n, p * s)
    vx = (slots[None, None, :] < gw[:, None, None]).expand(n, p, s).reshape(
        n, p * s)
    if group_size is not None:
        return _roi_align_matmul(features, ys, xs, vy, vx, 1.0 / gh,
                                 1.0 / gw, group_size, p, s)
    flat = features.permute(0, 2, 3, 1).reshape(b * h * w, c)
    return _pool_masked(flat, _Lattice(full_h, full_w, base, ys, xs), vy, vx,
                        1.0 / (gh * gw), p, s)


# values in one [n, PS, PS, 4, C] corner gather of the adaptive RoIAlign and
# in one [n, PS, PS, C] gather of the RoIPool
_GATHER_VALUES = 1 << 26


def _pool_masked(flat: torch.Tensor, lat: _Lattice, vy: torch.Tensor,
                 vx: torch.Tensor, inv_count: torch.Tensor, p: int, s: int
                 ) -> torch.Tensor:
    """The gather form of the adaptive RoIAlign (the JAX ``one_chunk``):
    each bin sums its live samples (``vy`` x ``vx``) and is scaled by the
    roi's ``inv_count``; chunks of rois keep a corner gather within
    ``_GATHER_VALUES`` values -> [N, C, P, P]."""
    c = flat.shape[1]
    acc_dt = _acc_dtype(flat.dtype)
    ps = p * s
    chunk = max(1, _GATHER_VALUES // (ps * ps * 4 * c))
    out = []
    for i in range(0, lat.base.shape[0], chunk):
        sl = slice(i, i + chunk)
        idx4, w4 = _corners(lat, sl)
        live = (vy[sl, :, None] & vx[sl, None, :])[..., None]
        w4 = torch.where(live, w4, torch.zeros_like(w4))
        val = (flat[idx4].to(acc_dt) * w4[..., None].to(acc_dt)).sum(-2)
        val = val.reshape(val.shape[0], p, s, p, s, c).sum(dim=(2, 4))
        out.append((val * inv_count[sl, None, None, None].to(acc_dt))
                   .to(flat.dtype))
    if not out:
        return flat.new_zeros((0, c, p, p))
    return torch.cat(out).permute(0, 3, 1, 2)


def _interp_matrix(coord: torch.Tensor, slot_valid: torch.Tensor,
                   inv_g: torch.Tensor, extent: int, p: int, s: int
                   ) -> torch.Tensor:
    """Per-roi separable interpolation matrix A [n, P, extent] (the JAX
    ``_interp_matrix``): A[i, k, e] sums, over bin k's live slots, the
    linear hat weight each sample puts on feature row (or column) e,
    divided by g, so that ``pooled = Ay F Ax^T`` is the sample-then-average
    of the gather form."""
    n = coord.shape[0]
    oob = (coord < -1.0) | (coord > extent)
    t = coord.clamp(0.0, extent - 1)
    t0 = torch.floor(t)
    t1 = torch.clamp(t0 + 1, max=extent - 1)
    lt = t - t0
    w2 = torch.stack([1.0 - lt, lt], dim=-1)
    w2 = torch.where(oob[..., None], torch.zeros_like(w2), w2)
    w2 = (torch.where(slot_valid[..., None], w2, torch.zeros_like(w2))
          * inv_g[:, None, None])
    a = coord.new_zeros((n, p * s, extent)).scatter_add_(
        2, torch.stack([t0, t1], dim=-1).long(), w2)
    return a.reshape(n, p, s, extent).sum(dim=2)


_MATMUL_ROIS = 64  # rois per product of the separable RoIAlign


def _roi_align_matmul(features: torch.Tensor, ys: torch.Tensor,
                      xs: torch.Tensor, vy: torch.Tensor, vx: torch.Tensor,
                      inv_gh: torch.Tensor, inv_gw: torch.Tensor, r: int,
                      p: int, s: int) -> torch.Tensor:
    """RoIAlign as pooled = Ay F Ax^T over rois grouped ``r`` per image
    (the JAX ``_roi_align_matmul``). Each chunk of at most ``_MATMUL_ROIS``
    rois of one image contracts the columns first, [C*H, W] @ [W, n*P],
    then the rows, one [P, H] @ [H, C*P] product per roi; both products
    run in the feature dtype (f32: f32 accumulation, TF32 as the global
    matmul setting has it, off by default). -> [N, C, P, P]."""
    b, c, h, w = features.shape
    n = ys.shape[0]
    if n != b * r:
        raise ValueError(f"{n} rois are not {b} images x {r}")
    dt = features.dtype
    ay = _interp_matrix(ys, vy, inv_gh, h, p, s).to(dt)  # [N, P, H]
    ax = _interp_matrix(xs, vx, inv_gw, w, p, s).to(dt)  # [N, P, W]
    out = []
    for i in range(b):
        f = features[i].reshape(c * h, w)
        for j in range(i * r, (i + 1) * r, _MATMUL_ROIS):
            sl = slice(j, min(j + _MATMUL_ROIS, (i + 1) * r))
            k = sl.stop - sl.start
            cols = f @ ax[sl].reshape(k * p, w).t()  # [C*H, k*P]
            cols = cols.reshape(c, h, k, p).permute(2, 1, 0, 3).reshape(
                k, h, c * p)
            pooled = torch.bmm(ay[sl], cols)  # [k, P, C*P]
            out.append(pooled.reshape(k, p, c, p).permute(0, 2, 1, 3))
    if not out:
        return features.new_zeros((0, c, p, p))
    return torch.cat(out)


def roi_pool(features: torch.Tensor, rois: torch.Tensor,
             batch_idx: torch.Tensor, output_size: int = 7,
             spatial_scale: float = 1.0) -> torch.Tensor:
    """RoIPool, max pooling (port of ``tpuseg/ops/sampling.py::roi_pool``,
    ROIPool_cuda.cu semantics): features [B, C, H, W], rois [N, 4] ->
    [N, C, P, P].

    The roi's corners are rounded to cells, its extent ``x2 - x1 + 1``
    (>= 1); bin k spans cells ``[floor(k sz / P), ceil((k + 1) sz / P))``
    from the roi's origin, clamped to the map, its bounds computed in
    integer arithmetic (a float ``(k + 1) sz / P`` can land just above an
    integer and take one cell too many); an empty bin is 0. Each bin looks
    at ``ceil(max(H, W) / P) + 2`` candidate cells per axis, which holds
    the widest bin of any roi."""
    b, c, h, w = features.shape
    n = rois.shape[0]
    p = output_size
    dev = rois.device
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale).long()
                      for i in range(4))
    roi_w = (x2 - x1 + 1).clamp(min=1)
    roi_h = (y2 - y1 + 1).clamp(min=1)
    s = -(-max(h, w) // p) + 2
    bins = torch.arange(p, device=dev)
    k = torch.arange(s, device=dev)

    def axis(start, size, extent):
        lo = (bins[None, :] * size[:, None] // p + start[:, None]).clamp(
            0, extent)
        hi = (-((-(bins[None, :] + 1) * size[:, None]) // p)
              + start[:, None]).clamp(0, extent)
        idx = (lo[:, :, None] + k).clamp(0, extent - 1)
        return idx.reshape(n, p * s), (k < (hi - lo)[:, :, None]).reshape(
            n, p * s)

    ys, yv = axis(y1, roi_h, h)
    xs, xv = axis(x1, roi_w, w)
    flat = features.permute(0, 2, 3, 1).reshape(b * h * w, c)
    base = batch_idx.long() * (h * w)
    chunk = max(1, _GATHER_VALUES // ((p * s) ** 2 * c))
    out = []
    for i in range(0, n, chunk):
        sl = slice(i, i + chunk)
        lin = (base[sl, None, None] + ys[sl, :, None] * w + xs[sl, None, :])
        g = flat[lin]  # [n, PS, PS, C]
        live = (yv[sl, :, None] & xv[sl, None, :])[..., None]
        g = g.masked_fill(~live, float("-inf"))
        m = g.reshape(g.shape[0], p, s, p, s, c).amax(dim=(2, 4))
        out.append(torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    if not out:
        return features.new_zeros((0, c, p, p))
    return torch.cat(out).permute(0, 3, 1, 2)


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


def sample_points_backward_plain(grad: torch.Tensor, feats: torch.Tensor,
                                 sy: torch.Tensor, sx: torch.Tensor,
                                 m: torch.Tensor | None = None,
                                 feats_grad: bool = True,
                                 coords_grad: bool = True) -> tuple:
    """Plain transpose of :func:`sample_points_plain` (the plain version of
    the backward kernel, ``csrc/dcn_sample_bwd.cu``): grad [B, S, C] ->
    (d feats [B, C, H, W] in the feature dtype, d sy, d sx and d m [B, S]
    in the coordinates' dtypes), each None where not asked for (d m also
    when ``m`` is None).

    The derivatives of the JAX gather path (floor rule, one-sided at
    integer coordinates), in the kernel's order: per sample, (g * m) * w
    of each corner inside the map is added into an f32 buffer by an
    explicit ``index_add_`` and cast to the feature dtype once; d sy = m *
    sum_c g * (-hx f00 - lx f01 + hx f10 + lx f11), d sx likewise with
    (-hy, hy, -ly, ly), d m = sum_c g * (the bilinear value), a corner
    outside the map read as 0. Chunked over S as the forward."""
    b, c, h, w = feats.shape
    acc_dt = _acc_dtype(feats.dtype)
    flat, base, chunk = _point_setup(feats)
    dflat = (torch.zeros((b * h * w, c), dtype=acc_dt, device=feats.device)
             if feats_grad else None)
    dsy, dsx, dm = [], [], []
    for i in range(0, sy.shape[1], chunk):
        g = grad[:, i:i + chunk].to(acc_dt)
        mc = None if m is None else m[:, i:i + chunk, None].to(acc_dt)
        gm = g if mc is None else g * mc
        ty = tx = val = None
        for idx, wgt, inside, dwy, dwx in _point_corners(
                sy[:, i:i + chunk], sx[:, i:i + chunk], h, w, base):
            wgt = wgt.to(acc_dt)[..., None]
            if feats_grad:
                dflat.index_add_(0, idx.reshape(-1), (gm * wgt).reshape(-1, c))
            if coords_grad:
                f = torch.where(inside[..., None], flat[idx].to(acc_dt), 0.0)
                terms = (f * dwy.to(acc_dt)[..., None],
                         f * dwx.to(acc_dt)[..., None], f * wgt)
                ty, tx, val = terms if ty is None else (
                    ty + terms[0], tx + terms[1], val + terms[2])
        if coords_grad:
            ay, ax = (g * ty).sum(-1), (g * tx).sum(-1)
            if mc is not None:
                ay, ax = ay * mc[..., 0], ax * mc[..., 0]
                dm.append((g * val).sum(-1))
            dsy.append(ay)
            dsx.append(ax)
    df = None
    if feats_grad:
        df = dflat.reshape(b, h, w, c).permute(0, 3, 1, 2).to(feats.dtype)
    if not coords_grad:
        return df, None, None, None

    def cat(parts, like):
        return (torch.cat(parts, dim=1) if parts
                else like.new_zeros(like.shape)).to(like.dtype)

    return (df, cat(dsy, sy), cat(dsx, sx),
            None if m is None else cat(dm, m))


def _kernel_points(feats, sy, sx, m):
    from tpuseg_torch.kernels import dcn as K

    return K.sample_points(feats, sy.float().contiguous(),
                           sx.float().contiguous(),
                           None if m is None else m.float().contiguous())


def _kernel_points_backward(grad, feats, sy, sx, m, feats_grad, coords_grad):
    from tpuseg_torch.kernels import dcn as K

    df, dsy, dsx, dm = K.sample_points_backward(
        grad.to(feats.dtype).contiguous(), feats, sy.float().contiguous(),
        sx.float().contiguous(),
        None if m is None else m.float().contiguous(), feats_grad,
        coords_grad)
    if coords_grad:
        dsy, dsx = dsy.to(sy.dtype), dsx.to(sx.dtype)
        dm = None if m is None else dm.to(m.dtype)
    return df, dsy, dsx, dm


def _points_backward_on(kernel: bool, grad, feats, sy, sx, m, feats_grad,
                        coords_grad) -> tuple:
    """The one place that picks the sampler's backward: the kernel if
    ``kernel``, else :func:`sample_points_backward_plain`."""
    back = (_kernel_points_backward if kernel
            else sample_points_backward_plain)
    return back(grad, feats, sy, sx, m, feats_grad, coords_grad)


def sample_points_backward(grad: torch.Tensor, feats: torch.Tensor,
                           sy: torch.Tensor, sx: torch.Tensor,
                           m: torch.Tensor | None = None,
                           feats_grad: bool = True,
                           coords_grad: bool = True) -> tuple:
    """:func:`sample_points_backward_plain`'s function: the backward kernel
    (``csrc/dcn_sample_bwd.cu``, on the features in ``torch.channels_last``)
    for CUDA tensors, the plain version for CPU tensors."""
    kernel = kernels.use_kernel(feats)
    if kernel:
        feats = feats.contiguous(memory_format=torch.channels_last)
    return _points_backward_on(kernel, grad, feats, sy, sx, m, feats_grad,
                               coords_grad)


class _SamplePoints(torch.autograd.Function):
    """The differentiable point sampler: the sampling kernel forward, the
    backward kernel backward (their plain versions on the CPU), chosen once,
    at the forward. It saves the channels-last features, the coordinates
    and the modulation; the backward computes only the gradients asked for.
    """

    @staticmethod
    def forward(ctx, feats, sy, sx, m):
        ctx.kernel = kernels.use_kernel(feats)
        feats = feats.contiguous(memory_format=torch.channels_last)
        ctx.save_for_backward(feats, sy, sx, m)
        if ctx.kernel:
            return _kernel_points(feats, sy, sx, m)
        return sample_points_plain(feats, sy, sx, m)

    @staticmethod
    def backward(ctx, grad):
        feats, sy, sx, m = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = _points_backward_on(ctx.kernel, grad, feats, sy, sx, m,
                                    need[0], any(need[1:]))
        return tuple(g if n else None for g, n in zip(grads, need))


def sample_points(feats: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                  m: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`sample_points_plain`'s function, differentiable in the
    features, the coordinates and the modulation: the DCN sampling kernel
    (``csrc/dcn_sample.cu``) forward and its backward kernel
    (``csrc/dcn_sample_bwd.cu``) for CUDA tensors, on the features in
    ``torch.channels_last`` (a copy unless they are already), the plain
    versions for CPU tensors."""
    return _SamplePoints.apply(feats, sy, sx, m)


# ---------------------------------------------------------------------------
# Pose2Seg's AffineAlign (port of ``tpuseg/ops/sampling.py::affine_grid`` and
# ``affine_align``)
# ---------------------------------------------------------------------------


def affine_grid(theta: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``F.affine_grid(theta, (N, 1, out_h, out_w), align_corners=False)``'s
    function: theta [N, 2, 3] -> grid [N, out_h, out_w, 2] of (x, y) in
    [-1, 1]. The base grid is the JAX package's, ``(2 i + 1) / n - 1``,
    divided on the host in theta's dtype (so a CUDA grid equals a CPU one),
    and each coordinate is ``gx t0 + gy t1 + t2`` in that order."""
    dt = theta.dtype

    def base(n):
        return ((torch.arange(n, dtype=dt) * 2.0 + 1.0) / n - 1.0).to(
            theta.device)

    gx = base(out_w)[None, None, :]
    gy = base(out_h)[None, :, None]
    t = theta[:, :, :, None, None]  # [N, 2, 3, 1, 1]
    out = [gx * t[:, j, 0] + gy * t[:, j, 1] + t[:, j, 2] for j in range(2)]
    return torch.stack(out, dim=-1)


def affine_align(feats: torch.Tensor, theta: torch.Tensor,
                 out_size: int) -> torch.Tensor:
    """Pose2Seg's AffineAlign: feats [B, C, H, W]; theta [B, N, 2, 3]
    (normalised, output grid -> input, one per person slot) -> the crops
    [B, N, out, out, C], bilinear with zero padding and
    ``align_corners=False``.

    :func:`affine_grid`, the JAX package's conversion to pixels, then the
    differentiable point sampler :func:`sample_points` over the S = N out^2
    samples of each image, without modulation: the DCN sampling kernel
    (``csrc/dcn_sample.cu``) forward and ``csrc/dcn_sample_bwd.cu``'s
    d feats backward for CUDA tensors, whatever the map's size or dtype.
    The JAX package's choice between its window kernel and its gathers
    exists for the TPU's VMEM and is not ported; the gathers are the
    semantics both follow."""
    b, c, h, w = feats.shape
    n = theta.shape[1]
    grid = affine_grid(theta.reshape(b * n, 2, 3), out_size, out_size)
    s = n * out_size * out_size
    sx = (((grid[..., 0] + 1.0) * w - 1.0) * 0.5).reshape(b, s)
    sy = (((grid[..., 1] + 1.0) * h - 1.0) * 0.5).reshape(b, s)
    return sample_points(feats, sy, sx).reshape(b, n, out_size, out_size, c)
