"""Fixed-shape box geometry (port of ``tpuseg/core/boxes.py``).

A set of N boxes is an ``[..., N, 4]`` float tensor (xyxy) plus an
``[..., N]`` bool validity mask; filtering flips mask bits or re-ranks and
never changes shapes, so every stage keeps the padded contract of the JAX
package.
"""
from __future__ import annotations

import torch

BBOX_XFORM_CLIP = 4.135166556742356  # log(1000 / 16), upstream default


def area(boxes: torch.Tensor, to_remove: float = 0.0) -> torch.Tensor:
    """Area of xyxy boxes; negative extents clamp to zero. ``to_remove=1``
    is detectron's +1-extent convention."""
    w = (boxes[..., 2] - boxes[..., 0] + to_remove).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1] + to_remove).clamp(min=0.0)
    return w * h


def pairwise_intersection(a: torch.Tensor, b: torch.Tensor,
                          to_remove: float = 0.0) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M] intersection areas."""
    ix = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]) + to_remove)
    iy = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]) + to_remove)
    return ix.clamp(min=0.0) * iy.clamp(min=0.0)


def iou_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-9,
               to_remove: float = 0.0) -> torch.Tensor:
    """Pairwise IoU [..., N, M]; ``to_remove=1`` matches detectron's nms.cu.

    The operation order (``(area_a + area_b) - inter``, then a true
    division) is the one the NMS kernel reproduces bit for bit.
    """
    inter = pairwise_intersection(a, b, to_remove)
    union = (area(a, to_remove)[..., :, None]
             + area(b, to_remove)[..., None, :] - inter)
    return inter / union.clamp(min=eps)


def iof_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-9,
               transpose: bool = False) -> torch.Tensor:
    """Intersection over the area of ``a`` (crowd handling) -> [..., N, M];
    ``transpose=True`` gives the same values as [..., M, N], computed in
    that layout (``tpuseg/core/boxes.py::iof_matrix``)."""
    if transpose:
        inter = pairwise_intersection(b, a)
        return inter / area(a)[..., None, :].clamp(min=eps)
    inter = pairwise_intersection(a, b)
    return inter / area(a)[..., :, None].clamp(min=eps)


def clip_to_image(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clamp xyxy coordinates to [0, width] x [0, height]; the bounds may be
    tensors that broadcast against ``boxes[..., 0]`` (one per image)."""
    height = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    width = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)

    def clip(v, hi):
        return torch.minimum(v.clamp(min=0.0), hi)

    return torch.stack([clip(boxes[..., 0], width), clip(boxes[..., 1], height),
                        clip(boxes[..., 2], width), clip(boxes[..., 3], height)],
                       dim=-1)


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Target ``boxes`` relative to ``anchors`` as (dx, dy, dw, dh):
    maskrcnn-benchmark BoxCoder.encode, +1 extents. Extents clamp at 1e-6,
    so a degenerate box sampled as a negative (whose encoding the loss never
    reads) cannot put an inf into the gradient through a masked row."""
    wx, wy, ww, wh = weights
    ex_w = (anchors[..., 2] - anchors[..., 0] + 1.0).clamp(min=1e-6)
    ex_h = (anchors[..., 3] - anchors[..., 1] + 1.0).clamp(min=1e-6)
    ex_cx = anchors[..., 0] + 0.5 * ex_w
    ex_cy = anchors[..., 1] + 0.5 * ex_h
    gt_w = (boxes[..., 2] - boxes[..., 0] + 1.0).clamp(min=1e-6)
    gt_h = (boxes[..., 3] - boxes[..., 1] + 1.0).clamp(min=1e-6)
    gt_cx = boxes[..., 0] + 0.5 * gt_w
    gt_cy = boxes[..., 1] + 0.5 * gt_h
    return torch.stack([wx * (gt_cx - ex_cx) / ex_w, wy * (gt_cy - ex_cy) / ex_h,
                        ww * torch.log(gt_w / ex_w), wh * torch.log(gt_h / ex_h)],
                       dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 clip: float = BBOX_XFORM_CLIP) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to anchors -> xyxy boxes.

    ``deltas`` may carry a trailing 4*K dim for class-specific regression;
    the anchor broadcasts over K. maskrcnn-benchmark BoxCoder.decode: +1
    extents, -1 on the output corner, dw/dh clamped at ``clip``.
    """
    wx, wy, ww, wh = weights
    w = anchors[..., 2] - anchors[..., 0] + 1.0
    h = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = anchors[..., 0] + 0.5 * w
    cy = anchors[..., 1] + 0.5 * h

    shp = deltas.shape
    k = shp[-1] // 4
    d = deltas.reshape(shp[:-1] + (k, 4))
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = (d[..., 2] / ww).clamp(max=clip)
    dh = (d[..., 3] / wh).clamp(max=clip)

    pcx = dx * w[..., None] + cx[..., None]
    pcy = dy * h[..., None] + cy[..., None]
    pw = torch.exp(dw) * w[..., None]
    ph = torch.exp(dh) * h[..., None]

    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                       pcx + 0.5 * pw - 1.0, pcy + 0.5 * ph - 1.0], dim=-1)
    return out.reshape(shp[:-1] + (4 * k,)) if k > 1 else out[..., 0, :]


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1],
                       dim=-1)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def ssd_decode(loc: torch.Tensor, priors_cxcywh: torch.Tensor,
               variances=(0.1, 0.2)) -> torch.Tensor:
    """YOLACT/SSD decode (yolact ``layers/box_utils.py::decode``): loc
    deltas against (cx, cy, w, h) priors -> xyxy boxes, in the priors'
    normalised units."""
    v0, v1 = variances
    pxy, pwh = priors_cxcywh[..., :2], priors_cxcywh[..., 2:]
    cxy = pxy + loc[..., :2] * v0 * pwh
    wh = pwh * torch.exp(loc[..., 2:] * v1)
    return cxcywh_to_xyxy(torch.cat([cxy, wh], dim=-1))


def ssd_encode(matched_xyxy: torch.Tensor, priors_cxcywh: torch.Tensor,
               variances=(0.1, 0.2)) -> torch.Tensor:
    """Inverse of :func:`ssd_decode` (yolact ``box_utils.encode``): xyxy
    boxes against (cx, cy, w, h) priors -> loc targets; the extent ratio
    clamps at 1e-9 before the log, as the JAX package's does."""
    v0, v1 = variances
    pxy, pwh = priors_cxcywh[..., :2], priors_cxcywh[..., 2:]
    g_cxy = (matched_xyxy[..., :2] + matched_xyxy[..., 2:]) * 0.5
    g_wh = matched_xyxy[..., 2:] - matched_xyxy[..., :2]
    d_cxy = (g_cxy - pxy) / (v0 * pwh)
    d_wh = torch.log((g_wh / pwh).clamp(min=1e-9)) / v1
    return torch.cat([d_cxy, d_wh], dim=-1)


def masked_topk(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Top-k over the last axis with invalid entries ranked last.

    Returns (scores_k, indices_k, valid_k); invalid slots score -inf. When k
    exceeds N the outputs are padded to k with invalid slots (index 0).
    Ties keep index order (a stable sort), as ``jax.lax.top_k`` does:
    ``torch.topk`` gives no such guarantee, and tied scores would then
    select different boxes than the reference.
    """
    n = scores.shape[-1]
    neg = float("-inf")  # a Python scalar: no host-to-device copy, no sync
    masked = scores.masked_fill(~valid, neg)
    kk = min(k, n)
    top, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top, idx = top[..., :kk], idx[..., :kk]
    if kk < k:
        pad = list(top.shape[:-1]) + [k - kk]
        top = torch.cat([top, top.new_full(pad, neg)], dim=-1)
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
    return top, idx, top > neg


def gather_along_n(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``x`` ([B, N, ...rest]) by ``idx`` ([B, K])."""
    rest = x.shape[idx.ndim:]
    index = idx.reshape(idx.shape + (1,) * len(rest)).expand(idx.shape + rest)
    return torch.gather(x, idx.ndim - 1, index)
