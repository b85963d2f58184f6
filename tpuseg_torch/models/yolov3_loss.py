"""YOLOv3 training loss (port of ``tpuseg/models/yolov3_loss.py``;
yolo.jittor compute_loss).

Each ground truth is assigned to the anchor (of the 9 across the three
scales) with the best width-height IoU, at its centre's grid cell on that
anchor's scale. The terms:
  - xy: squared error of the sigmoid offsets against the in-cell fractions;
  - wh: squared error of the raw tw, th against log(gt / anchor);
  - obj: BCE towards 1 at the assigned slots; noobj: BCE towards 0 at the
    rest, except where a decoded prediction overlaps any ground truth
    above ``ignore_thresh``;
  - cls: one-hot BCE at the assigned slots.
xy, wh, obj and cls are divided by the number of ground truths in the
batch, noobj by the number of predictions.

Two ground truths that pick the same (cell, anchor) slot write one slot.
The JAX package scatters them with ``.at[].set``, whose order XLA leaves
open; XLA on the CPU applies them in index order, so the last one wins.
The port picks that one on every device: each slot's winner is the
largest index that targets it (``scatter_reduce`` with ``amax``), and the
slot's targets are gathered from it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tpuseg_torch.core import boxes as box_ops
from tpuseg_torch.models.yolov3 import (ANCHORS, NUM_ANCHORS, STRIDES,
                                        YoloV3Config, decode)


@dataclass(frozen=True)
class YoloLossConfig:
    ignore_thresh: float = 0.5
    obj_weight: float = 1.0
    noobj_weight: float = 100.0
    coord_weight: float = 1.0
    cls_weight: float = 1.0


def _bce(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """BCE with logits, the JAX package's formula term for term."""
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def build_targets_batch(gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                        level_hw: list, cfg: YoloV3Config) -> list:
    """gt_boxes [B, G, 4] xyxy in input px (padded), gt_classes [B, G]
    (0-based, -1 pads) -> per level (tconf [B, HWA] f32, txywh [B, HWA, 4]
    f32, tcls [B, HWA]), slots in (row, column, anchor) order."""
    dt, dev = gt_boxes.dtype, gt_boxes.device
    b, g = gt_classes.shape
    anchors = torch.tensor([a for lvl in ANCHORS for a in lvl], dtype=dt,
                           device=dev)  # [9, 2] px, level-major (32, 16, 8)
    valid = gt_classes >= 0
    cxy = (gt_boxes[..., :2] + gt_boxes[..., 2:]) * 0.5
    wh = gt_boxes[..., 2:] - gt_boxes[..., :2]
    inter = (torch.minimum(wh[..., None, 0], anchors[:, 0])
             * torch.minimum(wh[..., None, 1], anchors[:, 1]))
    union = ((wh[..., 0] * wh[..., 1])[..., None]
             + anchors[:, 0] * anchors[:, 1] - inter)
    best = torch.argmax(inter / union.clamp(min=1e-9), dim=-1)  # [B, G]
    best_level = best // NUM_ANCHORS
    best_a = best % NUM_ANCHORS
    aw, ah = anchors[best, 0], anchors[best, 1]
    tw = torch.log((wh[..., 0] / aw.clamp(min=1e-9)).clamp(min=1e-9))
    th = torch.log((wh[..., 1] / ah.clamp(min=1e-9)).clamp(min=1e-9))
    gt_index = torch.arange(g, device=dev).expand(b, g)
    out = []
    for li, (h, w) in enumerate(level_hw):
        stride = STRIDES[li]
        gx = cxy[..., 0] / stride
        gy = cxy[..., 1] / stride
        ci = gx.to(torch.int32).clamp(0, w - 1)
        cj = gy.to(torch.int32).clamp(0, h - 1)
        n = h * w * NUM_ANCHORS
        lin = (cj * w + ci) * NUM_ANCHORS + best_a
        lin = torch.where(valid & (best_level == li), lin, n).long()
        winner = torch.full((b, n + 1), -1, dtype=torch.long, device=dev)
        winner = winner.scatter_reduce(1, lin, gt_index, "amax")[:, :n]
        assigned = winner >= 0
        src = winner.clamp(min=0)
        # offsets from the clamped cell: a centre on the right or bottom
        # edge lands in cell w - 1 with offset 1.0, as the JAX package's
        vals = torch.stack([gx - ci.to(dt), gy - cj.to(dt), tw, th], -1)
        txywh = box_ops.gather_along_n(vals, src)
        # f32 targets, as the JAX package's (its target planes are f32
        # whatever the boxes' dtype)
        txywh = txywh.float()
        out.append((assigned.float(),
                    torch.where(assigned[..., None], txywh,
                                torch.zeros_like(txywh)),
                    torch.where(assigned,
                                torch.gather(gt_classes.clamp(min=0), 1, src),
                                torch.zeros_like(src, dtype=gt_classes.dtype))))
    return out


def build_targets(gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                  level_hw: list, cfg: YoloV3Config) -> list:
    """One image: gt_boxes [G, 4], gt_classes [G] -> per level (tconf
    [HWA], txywh [HWA, 4], tcls [HWA])."""
    return [tuple(t[0] for t in lvl) for lvl in build_targets_batch(
        gt_boxes[None], gt_classes[None], level_hw, cfg)]


def total_loss(raw_outs: list, gt_boxes: torch.Tensor,
               gt_classes: torch.Tensor, cfg: YoloV3Config,
               lcfg: YoloLossConfig = YoloLossConfig()) -> dict:
    """raw_outs: the three head maps [B, h, w, 3 * (5 + C)]; gt_boxes
    [B, G, 4] px; gt_classes [B, G] -> {xy, wh, obj, noobj, cls, total}."""
    b = raw_outs[0].shape[0]
    level_hw = [(o.shape[1], o.shape[2]) for o in raw_outs]
    with torch.no_grad():  # the ignore mask only: no gradient
        dec_boxes = decode(raw_outs, cfg)[0]
        iou = box_ops.iou_matrix(dec_boxes, gt_boxes.to(dec_boxes.dtype))
        iou = torch.where((gt_classes >= 0)[:, None, :], iou,
                          torch.zeros_like(iou))
        ignore = iou.amax(dim=-1) > lcfg.ignore_thresh  # [B, N]
    tgt = build_targets_batch(gt_boxes, gt_classes, level_hw, cfg)
    sums = {"xy": 0.0, "wh": 0.0, "obj": 0.0, "noobj": 0.0, "cls": 0.0}
    off = 0
    for o, (h, w), (tconf, txywh, tcls) in zip(raw_outs, level_hw, tgt):
        n = h * w * NUM_ANCHORS
        o = o.reshape(b, n, cfg.num_attrib)
        tconf, txywh = tconf.to(o.dtype), txywh.to(o.dtype)
        obj_mask = tconf > 0.5
        noobj_mask = ~obj_mask & ~ignore[:, off:off + n]
        off += n
        zero = torch.zeros((), dtype=o.dtype, device=o.device)
        sxy = torch.sigmoid(o[..., 0:2])
        sums["xy"] = sums["xy"] + torch.where(
            obj_mask[..., None], (sxy - txywh[..., 0:2]) ** 2, zero).sum()
        sums["wh"] = sums["wh"] + torch.where(
            obj_mask[..., None], (o[..., 2:4] - txywh[..., 2:4]) ** 2,
            zero).sum()
        conf_bce = _bce(o[..., 4], tconf)
        sums["obj"] = sums["obj"] + torch.where(obj_mask, conf_bce, zero).sum()
        sums["noobj"] = sums["noobj"] + torch.where(noobj_mask, conf_bce,
                                                    zero).sum()
        onehot = F.one_hot(tcls.long(), cfg.num_classes).to(o.dtype)
        cls_bce = _bce(o[..., 5:], onehot).sum(-1)
        sums["cls"] = sums["cls"] + torch.where(obj_mask, cls_bce, zero).sum()
    npos = (gt_classes >= 0).sum().clamp(min=1)
    out = {
        "xy": lcfg.coord_weight * sums["xy"] / npos,
        "wh": lcfg.coord_weight * sums["wh"] / npos,
        "obj": lcfg.obj_weight * sums["obj"] / npos,
        "noobj": lcfg.noobj_weight * sums["noobj"] / max(b * off, 1),
        "cls": lcfg.cls_weight * sums["cls"] / npos,
    }
    out["total"] = sum(out.values())
    return out
