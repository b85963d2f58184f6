"""The least time of a kernel's work on these inputs, from its shapes: the
bytes it must move over the card's memory rate against its f32 operations
over the rate outside the tensor cores, the larger of the two (copied from
``chip_smoke.py``: ``bound``, ``touched_cells``, ``roi_bound``,
``dcn_touched_cells``, ``dcn_bound``; the kernels compute in f32 for bf16
data too). The peaks are the H100 SXM's published dense rates at its full
700 W."""
from __future__ import annotations

import torch

from benchmark.reference.frozen import sampling

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # dense, the precision of the TF32 convolutions
ROI_OPS_PER_SAMPLE = 12  # per channel: 4 corner weights, 4 mul, 4 add
DCN_OPS_PER_VALUE = 12  # per sample and channel: 4 corner weights, 4 mul,
#                         3 add, the modulation


def bound(nbytes: float, ops: float) -> float:
    """Least seconds: bytes over the memory rate or f32 operations over the
    f32 rate, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def touched_cells(level_hw, boxes, bidx, levels, p: int, s: int = 2,
                  strides=(4, 8, 16, 32)) -> int:
    """Distinct (image, level, y, x) cells that the RoIAlign's bilinear
    samples weigh non-zero on these rois: the feature cells it needs."""
    lat, _, _ = sampling._pyramid_lattice(level_hw, boxes.float(), bidx,
                                          levels, p, s, strides)
    idx4, w4 = sampling._corners(lat, slice(None))
    return int(torch.unique(idx4[w4 != 0]).numel())


def roi_align_bound(level_hw, boxes, bidx, levels, p: int, c: int,
                    itemsize: int, pooled_itemsize: int | None = None,
                    s: int = 2, strides=(4, 8, 16, 32)) -> float:
    """One RoIAlign forward (K2) or backward (K3) on these rois: the touched
    cells' C channels read (or their gradient added into, counted once),
    the rois (f32 boxes, int32 image and level) read and [N, C, P, P]
    written (or read) in ``pooled_itemsize`` (default ``itemsize``); S*S
    samples a bin, ROI_OPS_PER_SAMPLE operations each per channel."""
    n = boxes.shape[0]
    pooled_itemsize = pooled_itemsize or itemsize
    cells = touched_cells(level_hw, boxes, bidx, levels, p, s, strides)
    nbytes = (cells * c * itemsize + n * (16 + 4 + 4)
              + n * c * p * p * pooled_itemsize)
    return bound(nbytes, n * c * p * p * s * s * ROI_OPS_PER_SAMPLE)


def dcn_touched_cells(sy, sx, h: int, w: int) -> int:
    """Distinct (image, y, x) cells that the samples weigh non-zero."""
    b = sy.shape[0]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    ly, lx = sy - y0, sx - x0
    base = (torch.arange(b, device=sy.device) * (h * w))[:, None]
    cells = []
    for yc, wy in ((y0, 1.0 - ly), (y0 + 1, ly)):
        for xc, wx in ((x0, 1.0 - lx), (x0 + 1, lx)):
            ok = ((yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
                  & (wy * wx != 0))
            cells.append(base.expand_as(yc)[ok] + (yc * w + xc)[ok].long())
    return int(torch.unique(torch.cat(cells)).numel())


def dcn_bound(feat_shape, itemsize: int, sy, sx) -> float:
    """One DCN sampling (K4): the touched cells' C channels, sy/sx/m read,
    [B, S, C] written; DCN_OPS_PER_VALUE f32 operations a value."""
    b, c, h, w = feat_shape
    s = sy.shape[1]
    nbytes = (dcn_touched_cells(sy, sx, h, w) * c * itemsize + b * s * 3 * 4
              + b * s * c * itemsize)
    return bound(nbytes, DCN_OPS_PER_VALUE * b * s * c)


def calls_bound(calls: dict, counts: dict, key: str, one) -> float:
    """Least seconds of every call of kernel ``key`` in the window: the sum
    of ``one(call)`` over the kept calls, scaled to all of them."""
    kept = calls.get(key, [])
    if not kept:
        return 0.0
    return sum(one(c) for c in kept) * counts[key] / len(kept)


def roi_call_bound(c: dict) -> float:
    return roi_align_bound(c["level_hw"], c["boxes"], c["bidx"], c["levels"],
                           c["p"], c["c"], c["itemsize"],
                           c.get("pooled_itemsize"), c["s"], c["strides"])


def dcn_call_bound(c: dict) -> float:
    return dcn_bound(c["shape"], c["itemsize"], c["sy"], c["sx"])


def roofline_pct(ctx: dict, keys_and_bounds, kernel_names) -> float | None:
    """100 x least time / device time of the kernels named, or None where
    the window ran none of them."""
    from benchmark.common import trace

    least = sum(calls_bound(ctx["calls"], ctx["counts"], k, one)
                for k, one in keys_and_bounds)
    spent = trace.kernel_seconds(ctx["events"], kernel_names)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
