"""Mask R-CNN training losses (port of ``tpuseg/models/maskrcnn_loss.py``).

maskrcnn-benchmark's Matcher, BalancedPositiveNegativeSampler, RPN loss
and RoI box and mask losses, in the static shapes of the JAX package:
sampling is a masked top-k over uniform scores, and every selection is a
fixed number of slots plus a validity mask.

Randomness: ``jax.random`` and ``torch.Generator`` give different numbers,
so the samplers take their uniform score vectors as tensors
(``pos_u``, ``neg_u``); the caller draws them
(:func:`tpuseg_torch.models.maskrcnn.forward_train_losses`), or a test
hands in the JAX package's own draws.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tpuseg_torch.core import boxes as box_ops
from tpuseg_torch.ops.sampling import roi_align


@dataclass(frozen=True)
class MaskRCNNLossConfig:
    """The JAX ``MaskRCNNLossConfig`` (same defaults), without its unread
    ``gt_mask_crop``: the crop size is the data layer's
    (``build_train_example(crop=...)``) and the loss reads it from the
    crops' shape."""
    rpn_fg_iou: float = 0.7
    rpn_bg_iou: float = 0.3
    rpn_batch_per_image: int = 256
    rpn_pos_fraction: float = 0.5
    roi_fg_iou: float = 0.5
    roi_bg_iou: float = 0.5
    roi_batch_per_image: int = 512
    roi_pos_fraction: float = 0.25
    num_classes: int = 81
    box_reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    mask_size: int = 28


def match_targets(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                  anchors: torch.Tensor, high: float, low: float,
                  allow_low_quality: bool,
                  anchor_valid: torch.Tensor | None = None):
    """Matcher: gt_boxes [G, 4] (padded), gt_valid [G], anchors [N, 4] ->
    (matched gt [N], label [N] in {1 fg, 0 bg, -1 ignore}).

    IoUs use +1 extents. With ``allow_low_quality`` every anchor that ties a
    gt's best IoU becomes fg and keeps its own best gt. ``anchor_valid``
    removes anchors from the IoU matrix itself (padded-canvas anchors that
    upstream's per-image grids do not have), so they cannot absorb a gt's
    forced match.
    """
    iou = box_ops.iou_matrix(gt_boxes, anchors, to_remove=1.0)  # [G, N]
    iou = iou.masked_fill(~gt_valid[:, None], -1.0)
    if anchor_valid is not None:
        iou = iou.masked_fill(~anchor_valid[None, :], -1.0)
    best, best_idx = iou.max(dim=0)  # first maximum, as jnp.argmax
    one, zero, ign = (torch.ones_like(best_idx), torch.zeros_like(best_idx),
                      torch.full_like(best_idx, -1))
    label = torch.where(best >= high, one, torch.where(best < low, zero, ign))
    if allow_low_quality:
        gt_best = iou.max(dim=1, keepdim=True).values  # [G, 1]
        is_best = (iou >= gt_best - 1e-7) & (gt_best > 0) & gt_valid[:, None]
        label = torch.where(is_best.any(dim=0), one, label)
    label = torch.where(best < 0, zero, label)  # no valid gt at all -> bg
    return best_idx, label


def balanced_sample(label: torch.Tensor, pos_u: torch.Tensor,
                    neg_u: torch.Tensor, batch_size: int, pos_fraction: float):
    """BalancedPositiveNegativeSampler in exactly ``batch_size`` slots ->
    (sel_idx, sel_pos, sel_valid), each [batch_size].

    Up to ``batch_size * pos_fraction`` positives (the top of ``pos_u``
    among them), then negatives (the top of ``neg_u``) to fill the batch;
    a stable compaction puts the positives first, so every positive lies in
    the first ``batch_size * pos_fraction`` slots.
    """
    cap = int(batch_size * pos_fraction)
    _, pos_idx, pos_valid = box_ops.masked_topk(pos_u, label == 1, cap)
    num_pos = pos_valid.sum()
    _, neg_idx, neg_valid = box_ops.masked_topk(neg_u, label == 0, batch_size)
    neg_rank = torch.cumsum(neg_valid.long(), 0) - 1
    neg_keep = neg_valid & (neg_rank < batch_size - num_pos)
    sel_idx = torch.cat([pos_idx, neg_idx])
    sel_pos = torch.cat([pos_valid, torch.zeros_like(neg_keep)])
    sel_valid = torch.cat([pos_valid, neg_keep])
    order = torch.argsort((~sel_valid).to(torch.int8), stable=True)[:batch_size]
    return sel_idx[order], sel_pos[order], sel_valid[order]


def smooth_l1(x: torch.Tensor, t: torch.Tensor, beta: float = 1.0):
    d = (x - t).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def _bce_with_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise, in the JAX package's form."""
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def rpn_loss(objectness: torch.Tensor, deltas: torch.Tensor,
             anchors: torch.Tensor, gt_boxes: torch.Tensor,
             gt_valid: torch.Tensor, draws, cfg: MaskRCNNLossConfig,
             image_hw: torch.Tensor | None = None,
             anchor_inside: torch.Tensor | None = None) -> dict:
    """RPNLossComputation: objectness [B, N] logits, deltas [B, N, 4],
    anchors [N, 4], gt [B, G, 4] / [B, G]; ``draws`` per image a pair of
    [N] uniform vectors. Sampled BCE + smooth-L1 (beta 1/9) over
    ``rpn_batch_per_image`` anchors per image, both divided by the number
    sampled. Anchors not wholly inside the real image (``image_hw``,
    STRADDLE_THRESH 0) are never sampled; ``anchor_inside`` [B, N] also
    removes padded-canvas anchors from the match matrix (see
    :func:`match_targets`)."""
    box_terms, obj_terms, counts = [], [], []
    for i in range(objectness.shape[0]):
        midx, label = match_targets(
            gt_boxes[i], gt_valid[i], anchors, cfg.rpn_fg_iou, cfg.rpn_bg_iou,
            True, None if anchor_inside is None else anchor_inside[i])
        if image_hw is not None:
            h = image_hw[i, 0].to(anchors.dtype)
            w = image_hw[i, 1].to(anchors.dtype)
            visible = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
                       & (anchors[:, 2] < w) & (anchors[:, 3] < h))
            label = torch.where(visible, label, torch.full_like(label, -1))
        sel_idx, sel_pos, sel_valid = balanced_sample(
            label, *draws[i], cfg.rpn_batch_per_image, cfg.rpn_pos_fraction)
        tgt = box_ops.encode_boxes(gt_boxes[i][midx[sel_idx]], anchors[sel_idx])
        l1 = smooth_l1(deltas[i][sel_idx], tgt, beta=1.0 / 9).sum(-1)
        box_terms.append(torch.where(sel_pos, l1, torch.zeros_like(l1)).sum())
        x = objectness[i][sel_idx]
        bce = _bce_with_logits(x, sel_pos.to(x.dtype))
        obj_terms.append(torch.where(sel_valid, bce, torch.zeros_like(bce)).sum())
        counts.append(sel_valid.sum())
    total = torch.stack(counts).sum().clamp(min=1).to(objectness.dtype)
    return {"loss_rpn_box_reg": torch.stack(box_terms).sum() / total,
            "loss_objectness": torch.stack(obj_terms).sum() / total}


def sample_proposals(proposals: torch.Tensor, prop_valid: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                     gt_valid: torch.Tensor, pos_u: torch.Tensor,
                     neg_u: torch.Tensor, cfg: MaskRCNNLossConfig) -> dict:
    """box_head/loss.py subsample, one image: the gt boxes are appended to
    the proposals ([P + G] candidates, the size of ``pos_u``/``neg_u``),
    matched without low-quality forcing, and ``roi_batch_per_image`` are
    sampled. -> boxes, gt_idx, cls_target (1-based, 0 = background),
    reg_target, pos, valid; each [roi_batch_per_image, ...]."""
    boxes = torch.cat([proposals, gt_boxes])
    valid = torch.cat([prop_valid, gt_valid])
    midx, label = match_targets(gt_boxes, gt_valid, boxes, cfg.roi_fg_iou,
                                cfg.roi_bg_iou, False)
    label = torch.where(valid, label, torch.full_like(label, -1))
    sel_idx, sel_pos, sel_valid = balanced_sample(
        label, pos_u, neg_u, cfg.roi_batch_per_image, cfg.roi_pos_fraction)
    sel_boxes = boxes[sel_idx]
    sel_gt = midx[sel_idx]
    cls = gt_classes[sel_gt].long() + 1
    return {
        "boxes": sel_boxes,
        "gt_idx": sel_gt,
        "cls_target": torch.where(sel_pos, cls, torch.zeros_like(cls)),
        "reg_target": box_ops.encode_boxes(gt_boxes[sel_gt], sel_boxes,
                                           cfg.box_reg_weights),
        "pos": sel_pos,
        "valid": sel_valid,
    }


def box_head_loss(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
                  sample: dict, cfg: MaskRCNNLossConfig) -> dict:
    """Cross-entropy over the sampled rois + class-specific smooth-L1
    (beta 1) over the positives, both divided by the number sampled."""
    valid, pos, labels = sample["valid"], sample["pos"], sample["cls_target"]
    ce = -F.log_softmax(cls_logits, -1).gather(1, labels[:, None])[:, 0]
    cls_l = torch.where(valid, ce, torch.zeros_like(ce)).sum()
    d = box_deltas.reshape(-1, cfg.num_classes, 4)
    d_cls = d.gather(1, labels[:, None, None].expand(-1, 1, 4))[:, 0]
    l1 = smooth_l1(d_cls, sample["reg_target"], beta=1.0).sum(-1)
    box_l = torch.where(pos, l1, torch.zeros_like(l1)).sum()
    total = valid.sum().clamp(min=1).to(cls_logits.dtype)
    return {"loss_classifier": cls_l / total, "loss_box_reg": box_l / total}


def mask_targets_from_crops(rois: torch.Tensor, gt_idx: torch.Tensor,
                            gt_boxes: torch.Tensor,
                            gt_mask_crops: torch.Tensor,
                            mask_size: int) -> torch.Tensor:
    """Each roi's mask target: its gt's R x R mask crop (which spans the gt
    box) pooled over the roi's frame inside that box with aligned RoIAlign,
    2 x 2 samples per cell, thresholded at 0.5 -> [S, M, M] float 0/1.
    rois [S, 4] image coordinates, gt_idx [S], gt_boxes [G, 4],
    gt_mask_crops [G, R, R]. Each gt's crop is one image of the pooled
    batch (the JAX package pools the crops as channels; the values agree)."""
    r = gt_mask_crops.shape[1]
    gb = gt_boxes[gt_idx]
    scale_x = r / (gb[:, 2] - gb[:, 0]).clamp(min=1e-4)
    scale_y = r / (gb[:, 3] - gb[:, 1]).clamp(min=1e-4)
    local = torch.stack([(rois[:, 0] - gb[:, 0]) * scale_x,
                         (rois[:, 1] - gb[:, 1]) * scale_y,
                         (rois[:, 2] - gb[:, 0]) * scale_x,
                         (rois[:, 3] - gb[:, 1]) * scale_y], -1)
    out = roi_align(gt_mask_crops[:, None].float(), local, gt_idx,
                    output_size=mask_size, spatial_scale=1.0,
                    sampling_ratio=2, aligned=True)
    return (out[:, 0] > 0.5).float()


def mask_head_loss_selected(x: torch.Tensor, sample: dict,
                            targets28: torch.Tensor,
                            cfg: MaskRCNNLossConfig) -> dict:
    """Mask BCE over the positives: x [S, M, M] logits of each roi's gt
    class, targets28 [S, M, M]; the mean per roi, summed over positives and
    divided by their number."""
    per = _bce_with_logits(x, targets28).mean(dim=(1, 2))
    pos = sample["pos"]
    total = pos.sum().clamp(min=1).to(x.dtype)
    return {"loss_mask": torch.where(pos, per, torch.zeros_like(per)).sum()
            / total}
