"""Frozen copy of the port's ``tpuseg_torch/ops/nms.py`` (plain paths only),
for the benchmark's reference; it imports nothing of the port.

Static-shape greedy NMS (port of ``tpuseg/ops/nms.py``).

Boxes are never filtered, only ranked and masked: every function takes and
returns fixed-shape tensors. :func:`nms_mask_batch` is the dispatching
entry point: the CUDA kernel (``csrc/nms.cu``) for CUDA tensors, the plain
:func:`nms_mask` for CPU tensors (see :mod:`tpuseg_torch.kernels`).
"""
from __future__ import annotations

import torch

from . import boxes as box_ops

NEG_INF = -1e10
TILE = 128  # boxes per tile of the plain fixed-point NMS


def _sort_desc(scores: torch.Tensor, valid: torch.Tensor):
    """Invalid entries score NEG_INF; a stable sort keeps ties in index
    order, as ``jnp.argsort(-masked)`` does. -> (the sorted validity,
    the order)."""
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    smasked, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    return smasked > NEG_INF, order


def _self_suppress_tile(adj: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact greedy suppression within a tile: the unique fixed point of
    kept(j) = valid(j) and not any_i(adj[i, j] and kept(i)), iterated from
    kept = valid. ``adj`` [B, T, T] ("i suppresses j"), ``valid`` [B, T]."""
    kept = valid
    for _ in range(valid.shape[-1]):
        new = valid & ~(adj & kept[:, :, None]).any(dim=1)
        if torch.equal(new, kept):
            break
        kept = new
    return kept


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: torch.Tensor | None = None,
             to_remove: float = 0.0) -> torch.Tensor:
    """Plain exact greedy NMS, batched: [B, N, 4], [B, N] -> keep [B, N].

    The tiled fixed-point algorithm of the JAX ``nms_mask``: in score
    order, each tile is first suppressed by the earlier tiles' survivors
    (one masked IoU reduction), then resolves its own chain by iterating
    the keep recursion to its fixed point.
    """
    b, n = scores.shape
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    svalid, order = _sort_desc(scores, valid)
    sboxes = box_ops.gather_along_n(boxes, order)
    alive = svalid.clone()
    for start in range(0, n, TILE):
        stop = min(start + TILE, n)
        tb = sboxes[:, start:stop]
        tv = svalid[:, start:stop]
        if start:
            iou = box_ops.iou_matrix(tb, sboxes[:, :start], to_remove=to_remove)
            tv = tv & ~((iou > iou_threshold)
                        & alive[:, None, :start]).any(dim=-1)
        iou_tt = box_ops.iou_matrix(tb, tb, to_remove=to_remove)
        upper = torch.ones(stop - start, stop - start, dtype=torch.bool,
                           device=boxes.device).triu(1)
        alive[:, start:stop] = _self_suppress_tile(
            (iou_tt > iou_threshold) & upper, tv)
    return torch.zeros_like(alive).scatter_(1, order, alive & svalid)


def nms_mask_batch(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_threshold: float, valid: torch.Tensor | None = None,
                   to_remove: float = 0.0) -> torch.Tensor:
    """Per-image NMS over a batch: [B, N, 4] / [B, N] -> keep [B, N].

    For CUDA tensors: the score sort in torch, then one launch of the NMS
    kernel for the whole batch, which reads the boxes through the order and
    writes the keep mask in the boxes' own order. For CPU tensors:
    :func:`nms_mask`.
    """
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    return nms_mask(boxes, scores, iou_threshold, valid, to_remove=to_remove)


def fast_nms(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.5, top_k: int = 200):
    """YOLACT Fast-NMS (``layers/functions/detection.py::fast_nms``),
    batched: boxes [B, N, 4], per-class scores [B, C, N] (no background).

    Per class the exact top ``top_k`` scores, ties to the lower index (a
    stable sort, as ``jax.lax.top_k``; ``torch.topk`` does not promise
    it), the IoU matrix of their boxes, its strict upper triangle, and a
    box kept iff its largest IoU with a higher-scored box of its class is
    <= ``iou_threshold``. Returns (boxes [B, C, K, 4], scores [B, C, K],
    classes [B, C, K], prior index [B, C, K], keep [B, C, K]).
    """
    b, c, n = scores.shape
    k = min(top_k, n)
    top_scores, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[..., :k], idx[..., :k]
    cboxes = box_ops.gather_along_n(boxes, idx.reshape(b, c * k))
    cboxes = cboxes.reshape(b, c, k, 4)
    iou = box_ops.iou_matrix(cboxes, cboxes).triu(diagonal=1)
    keep = iou.amax(dim=-2) <= iou_threshold
    classes = torch.arange(c, device=scores.device)[None, :, None]
    classes = classes.expand(b, c, k)
    return cboxes, top_scores, classes, idx, keep
