"""RetinaNet R-50/101-FPN inference and training forward (port of
``tpuseg/models/retinanet.py``; maskrcnn-benchmark's
``retinanet_R-50-FPN_1x``).

ResNet C3-C5 -> FPN P3-P5 with P6 and P7 (P6 a stride-2 conv of C5, P7 one
of relu(P6)) -> the shared 4-conv class and box towers -> per-anchor
sigmoid class scores and box deltas. Inference: per level the exact top
1000 (anchor, class) pairs above 0.05, decoded and clipped; one class-aware
NMS at 0.4 over every level's candidates; the top 100. Training: the
sigmoid focal loss over every anchor and class, and smooth-L1 over the
positives.

The padded contract of :mod:`tpuseg_torch.models.maskrcnn` is kept: the
static canvas, anchors of the padded region masked in inference and in the
matcher. Module paths are the maskrcnn-benchmark keys:
``backbone.body.*``, ``backbone.fpn.fpn_inner{2,3,4}``,
``fpn_layer{2,3,4}``, ``top_blocks.{p6,p7}``,
``rpn.head.{cls,bbox}_tower.{0,2,4,6}``, ``rpn.head.cls_logits``,
``rpn.head.bbox_pred``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from tpuseg_torch.core import boxes as box_ops
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models.maskrcnn_loss import match_targets, smooth_l1
from tpuseg_torch.nn.fpn import FPN, Backbone, LastLevelP6P7
from tpuseg_torch.nn.resnet import ResNet
from tpuseg_torch.ops import nms as nms_ops
from tpuseg_torch.ops.losses import sigmoid_focal_loss
from tpuseg_torch.parallel import ddp


@dataclass(frozen=True)
class RetinaNetConfig:
    """The JAX ``RetinaNetConfig``'s fields (same defaults), without its
    ``approx_topk`` (the port keeps the exact top-k)."""
    depth: int = 50
    freeze_at: int = 2
    # 3 octave scales x 3 ratios = 9 anchors a cell
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    anchor_stride: tuple = (8, 16, 32, 64, 128)
    octave: float = 2.0
    scales_per_octave: int = 3
    num_classes: int = 81  # with the background slot: nc - 1 sigmoid logits
    num_convs: int = 4
    prior_prob: float = 0.01
    fpn_channels: int = 256
    # inference (RETINANET.PRE_NMS_TOP_N, INFERENCE_TH, NMS_TH,
    # TEST.DETECTIONS_PER_IMG)
    pre_nms_top_n: int = 1000  # per level
    score_thresh: float = 0.05
    nms_thresh: float = 0.4
    detections_per_img: int = 100
    box_reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    # training (FG_IOU_THRESHOLD, BG_IOU_THRESHOLD, LOSS_*, BBOX_REG_*)
    fg_iou: float = 0.5
    bg_iou: float = 0.4
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    bbox_reg_beta: float = 0.11
    bbox_reg_norm: float = 4.0


def num_anchors_per_cell(cfg: RetinaNetConfig) -> int:
    return cfg.scales_per_octave * len(cfg.anchor_ratios)


@functools.lru_cache(maxsize=16)
def make_anchors_np(cfg: RetinaNetConfig, canvas_h: int, canvas_w: int):
    """Per-level anchors [Hl*Wl*A, 4]: sizes ``ANCHOR_SIZES[l] * octave **
    (i / scales_per_octave)``, the cell's A in ratio-major order (for each
    ratio, the octave scales), the head's channel order."""
    out = []
    for size, stride in zip(cfg.anchor_sizes, cfg.anchor_stride):
        cells = [M._generate_cell_anchors(
            size * cfg.octave ** (i / cfg.scales_per_octave),
            cfg.anchor_ratios, base=stride)
            for i in range(cfg.scales_per_octave)]  # [scale][ratio, 4]
        cell = np.stack(cells, axis=0).transpose(1, 0, 2).reshape(-1, 4)
        hl, wl = M.fpn_level_hw(canvas_h, canvas_w, stride)
        shift_x, shift_y = np.meshgrid(np.arange(wl) * stride,
                                       np.arange(hl) * stride)
        shifts = np.stack([shift_x.ravel(), shift_y.ravel(),
                           shift_x.ravel(), shift_y.ravel()], 1)
        out.append((shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)
                   .astype(np.float32))
    return out


@functools.lru_cache(maxsize=16)
def _anchors_on(cfg: RetinaNetConfig, canvas_h: int, canvas_w: int,
                device: torch.device) -> tuple:
    return tuple(torch.from_numpy(a).to(device)
                 for a in make_anchors_np(cfg, canvas_h, canvas_w))


def _inside_masks(cfg: RetinaNetConfig, image_hw: torch.Tensor,
                  canvas_hw: tuple, anchors: tuple) -> list:
    """Per level [B, Hl*Wl*A]: the anchors whose cell lies inside each
    image's real feature extent (upstream's per-image anchor grids)."""
    out = []
    for stride, an in zip(cfg.anchor_stride, anchors):
        hl, wl = M.fpn_level_hw(canvas_hw[0], canvas_hw[1], stride)
        out.append(M.anchor_inside_mask(image_hw, stride, hl, wl,
                                        an.shape[0] // (hl * wl)))
    return out


# ---------------------------------------------------------------------------
# Modules (attribute paths = maskrcnn-benchmark state_dict keys)
# ---------------------------------------------------------------------------


def _tower(channels: int, num_convs: int) -> nn.Sequential:
    """conv, ReLU, ... (the convs at indices 0, 2, 4, 6, as upstream)."""
    layers = []
    for _ in range(num_convs):
        layers += [nn.Conv2d(channels, channels, 3, padding=1),
                   nn.ReLU()]
    return nn.Sequential(*layers)


class RetinaNetHead(nn.Module):
    def __init__(self, cfg: RetinaNetConfig):
        super().__init__()
        c, a = cfg.fpn_channels, num_anchors_per_cell(cfg)
        self.num_classes = cfg.num_classes - 1
        self.cls_tower = _tower(c, cfg.num_convs)
        self.bbox_tower = _tower(c, cfg.num_convs)
        self.cls_logits = nn.Conv2d(c, a * self.num_classes, 3, padding=1)
        self.bbox_pred = nn.Conv2d(c, a * 4, 3, padding=1)

    def forward(self, feats: list):
        """-> per level: class logits [B, H*W*A, nc - 1] and box deltas
        [B, H*W*A, 4], in the (H, W, A) order of :func:`make_anchors_np`."""
        logits, deltas = [], []
        for f in feats:
            b = f.shape[0]
            logits.append(self.cls_logits(self.cls_tower(f)).permute(
                0, 2, 3, 1).reshape(b, -1, self.num_classes))
            deltas.append(self.bbox_pred(self.bbox_tower(f)).permute(
                0, 2, 3, 1).reshape(b, -1, 4))
        return logits, deltas


class RetinaNetModule(nn.Module):
    def __init__(self, cfg: RetinaNetConfig):
        super().__init__()
        self.head = RetinaNetHead(cfg)


class RetinaNet(nn.Module):
    """``backbone`` (body + fpn with P6/P7), ``rpn`` (the head, where
    upstream keeps it); ``cfg`` rides along."""

    def __init__(self, cfg: RetinaNetConfig = RetinaNetConfig()):
        super().__init__()
        self.cfg = cfg
        body = ResNet(cfg.depth, freeze_at=cfg.freeze_at)
        fpn = FPN(body.out_channels[1:], cfg.fpn_channels, first=2,
                  top_blocks=LastLevelP6P7(body.out_channels[-1],
                                           cfg.fpn_channels))
        self.backbone = Backbone(body, fpn)
        self.rpn = RetinaNetModule(cfg)


def prior_bias(cfg: RetinaNetConfig) -> float:
    """The class logits' bias that starts every sigmoid at ``prior_prob``
    (upstream's head init)."""
    return -math.log((1 - cfg.prior_prob) / cfg.prior_prob)


def build_model(cfg: RetinaNetConfig = RetinaNetConfig(),
                generator: torch.Generator | None = None) -> RetinaNet:
    """A CPU model: random weights from ``generator`` (as
    :func:`tpuseg_torch.models.maskrcnn.init_weights`, the class logits'
    bias at :func:`prior_bias`) if one is given, otherwise uninitialised
    storage for ``load_state_dict`` to fill."""
    with torch.device("meta"):
        model = RetinaNet(cfg)
    model = model.to_empty(device="cpu")
    if generator is not None:
        M.init_weights(model, generator)
        with torch.no_grad():
            model.rpn.head.cls_logits.bias.fill_(prior_bias(cfg))
    return model.eval()


# ---------------------------------------------------------------------------
# Inference (retinanet/inference.py RetinaNetPostProcessor)
# ---------------------------------------------------------------------------


def forward_heads(model: RetinaNet, pyramid: list, image_hw: torch.Tensor,
                  canvas_hw: tuple) -> dict:
    """The head and the post-processing on the pyramid [P3..P7] of a
    [B, 3, *canvas_hw] batch -> padded detections, and the final NMS's
    inputs' validity ``candidate_valid`` [B, sum of k over levels]."""
    cfg = model.cfg
    b = pyramid[0].shape[0]
    nc = cfg.num_classes - 1
    logits, deltas = model.rpn.head(pyramid)
    anchors = _anchors_on(cfg, canvas_hw[0], canvas_hw[1], pyramid[0].device)
    inside = _inside_masks(cfg, image_hw, canvas_hw, anchors)
    lvl_boxes, lvl_scores, lvl_classes, lvl_valid = [], [], [], []
    for lg, dl, an, ins in zip(logits, deltas, anchors, inside):
        scores = torch.sigmoid(lg.float())  # [B, N, nc]
        # the exact top-k in two stages: the top k anchors by their best
        # class hold every pair of the top k pairs (a pair's anchor has a
        # best class at least as high, and at most k - 1 pairs outrank it)
        max_s = scores.amax(dim=-1)
        k = min(cfg.pre_nms_top_n, lg.shape[1])
        _, a_sel, a_valid = box_ops.masked_topk(
            max_s, ins & (max_s > cfg.score_thresh), k)
        sub = box_ops.gather_along_n(scores, a_sel)  # [B, K, nc]
        sub_cand = a_valid[..., None] & (sub > cfg.score_thresh)
        top_s, sel, sel_valid = box_ops.masked_topk(
            sub.reshape(b, -1), sub_cand.reshape(b, -1), k)
        a_idx = torch.gather(a_sel, 1, sel // nc)
        boxes = box_ops.decode_boxes(
            box_ops.gather_along_n(dl.float(), a_idx), an[a_idx],
            weights=cfg.box_reg_weights)
        lvl_boxes.append(M._clip_per_image(boxes, image_hw))
        lvl_scores.append(torch.where(sel_valid, top_s,
                                      torch.zeros_like(top_s)))
        lvl_classes.append(sel % nc)
        lvl_valid.append(sel_valid)
    all_boxes = torch.cat(lvl_boxes, 1)
    all_scores = torch.cat(lvl_scores, 1)
    all_classes = torch.cat(lvl_classes, 1)
    all_valid = torch.cat(lvl_valid, 1)
    # class-aware NMS over all levels (boxlist_ml_nms), the JAX package's
    # batch-wide coordinate offset
    keep = nms_ops.batched_nms_mask_batch(all_boxes, all_scores, all_classes,
                                          cfg.nms_thresh, valid=all_valid,
                                          to_remove=1.0)
    neg = torch.full_like(all_scores, float("-inf"))
    fin_s, fidx, fvalid = box_ops.masked_topk(
        torch.where(keep, all_scores, neg), keep, cfg.detections_per_img)
    return {
        "boxes": box_ops.gather_along_n(all_boxes, fidx),
        "scores": torch.where(fvalid, fin_s, torch.zeros_like(fin_s)),
        "classes": torch.gather(all_classes, 1, fidx),  # 0-based
        "valid": fvalid,
        "candidate_valid": all_valid,
    }


def forward_inference(model: RetinaNet, images: torch.Tensor,
                      image_hw: torch.Tensor) -> dict:
    """images [B, 3, Hc, Wc] preprocessed on the static canvas; image_hw
    [B, 2] real sizes -> padded detections ([B, 100] plus ``valid``)."""
    return forward_heads(model, model.backbone(images), image_hw,
                         tuple(images.shape[-2:]))


# ---------------------------------------------------------------------------
# Training loss (retinanet/loss.py RetinaNetLossComputation)
# ---------------------------------------------------------------------------


def forward_train_losses(model: RetinaNet, images: torch.Tensor,
                         image_hw: torch.Tensor, targets: dict,
                         generator: torch.Generator | None = None) -> dict:
    """The focal classification loss over every anchor and class, divided
    by (positives + B), and smooth-L1 (beta 0.11) over the positives'
    deltas, divided by (positives x 4); port of
    ``tpuseg/models/retinanet.py::forward_train_losses``. targets:
    ``boxes`` [B, G, 4] canvas coordinates, ``classes`` [B, G] (0-based, -1
    pads). Anchors of the padded canvas are left out of the match matrix
    and contribute no term. No sampling, so no draws: ``generator`` is
    unused, taken so that every variant's training forward has one
    signature."""
    cfg = model.cfg
    b = images.shape[0]
    canvas = tuple(images.shape[-2:])
    logits, deltas = model.rpn.head(model.backbone(images))
    per_level = _anchors_on(cfg, canvas[0], canvas[1], images.device)
    anchors = torch.cat(per_level)
    all_logits = torch.cat([lg.float() for lg in logits], 1)
    all_deltas = torch.cat([dl.float() for dl in deltas], 1)
    inside = torch.cat(_inside_masks(cfg, image_hw, canvas, per_level), 1)
    gt_boxes, gt_classes = targets["boxes"], targets["classes"]
    gt_valid = gt_classes >= 0
    cls_terms, reg_terms, n_pos = [], [], []
    for i in range(b):
        midx, label = match_targets(gt_boxes[i], gt_valid[i], anchors,
                                    cfg.fg_iou, cfg.bg_iou, True,
                                    anchor_valid=inside[i])
        # focal targets: 0 background, 1..nc-1 the class, < 0 ignored
        # (between the thresholds, and every padded-canvas anchor)
        cls_t = torch.where(label == 1, gt_classes[i][midx].long() + 1,
                            torch.where(label == 0, torch.zeros_like(label),
                                        torch.full_like(label, -1)))
        cls_t = torch.where(inside[i], cls_t, torch.full_like(cls_t, -1))
        pos = (label == 1) & inside[i]
        cls_terms.append(sigmoid_focal_loss(
            all_logits[i], cls_t, gamma=cfg.focal_gamma,
            alpha=cfg.focal_alpha).sum())
        tgt = box_ops.encode_boxes(gt_boxes[i][midx], anchors,
                                   weights=cfg.box_reg_weights)
        l1 = smooth_l1(all_deltas[i], tgt, beta=cfg.bbox_reg_beta).sum(-1)
        reg_terms.append(torch.where(pos, l1, torch.zeros_like(l1)).sum())
        n_pos.append(pos.sum())
    num_pos = torch.stack(n_pos).sum().to(all_logits.dtype)
    losses = {
        "loss_retina_cls": torch.stack(cls_terms).sum()
        / ddp.denominator(num_pos + b),
        "loss_retina_reg": torch.stack(reg_terms).sum()
        / ddp.denominator(num_pos * cfg.bbox_reg_norm, 1.0),
    }
    losses["total"] = losses["loss_retina_cls"] + losses["loss_retina_reg"]
    return losses
