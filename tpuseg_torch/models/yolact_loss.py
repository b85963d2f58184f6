"""YOLACT training loss (port of ``tpuseg/models/yolact_loss.py``, upstream
Yolact ``layers/modules/multibox_loss.py``).

Static shapes throughout: targets arrive padded to G gts per image
(classes -1 for padding), positives are weight masks, never filters, and
the batch dimension is written out where the JAX package vmaps:

  B: SSD matching (pos 0.5 / neg 0.4, forced best prior per gt claimed in
     G rounds over a per-gt top-G compaction, crowd neutralisation), then
     smooth-L1 on the encoded offsets (alpha 1.5);
  C: cross-entropy with OHEM at 3:1 negatives to positives, mined on the
     SSD log-sum-exp proxy;
  M: BCE of sigmoid(proto @ coeff) against the gt mask at proto
     resolution, cropped to the gt box and divided by its area, over up to
     ``masks_to_train`` positives per image picked by caller-given uniform
     draws (alpha 6.125);
  S: per-class BCE of the semantic logits at P3 (alpha 1);
  I: (YOLACT++) smooth-L1 between FastMaskIoUNet's prediction on the
     assembled masks and their true IoU with the gt (alpha 25).

B, C, M and I are divided by the batch's positives, S by the batch size;
under a process group, the global batch's (``parallel/ddp.py``). Nothing
here reads a value back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tpuseg_torch.core import boxes as box_ops
from tpuseg_torch.parallel import ddp


@dataclass(frozen=True)
class YolactLossConfig:
    pos_thresh: float = 0.5
    neg_thresh: float = 0.4
    crowd_iou_threshold: float = 0.7
    negpos_ratio: int = 3
    bbox_alpha: float = 1.5
    conf_alpha: float = 1.0
    mask_alpha: float = 6.125
    semantic_alpha: float = 1.0
    masks_to_train: int = 100
    # YOLACT++ FastMaskIoUNet training: gt masks of at most
    # discard_mask_area proto pixels give no I term (upstream 5 * 5)
    use_maskiou: bool = False
    maskiou_alpha: float = 25.0
    discard_mask_area: float = 25.0


def match_priors(gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                 gt_crowd: torch.Tensor, priors: torch.Tensor,
                 cfg: YolactLossConfig) -> tuple:
    """gt_boxes [B, G, 4] normalised xyxy, gt_classes [B, G] (0-based, -1
    padding), gt_crowd [B, G] bool, priors [N, 4] (cx, cy, w, h) ->
    (conf_t [B, N] in {-1 neutral, 0 background, c + 1}, matched gt index
    [B, N], loc_t [B, N, 4]).

    Each valid gt claims its best prior (overlap := 2) in G rounds, the
    globally best (gt, prior) pair first, that gt and prior then excluded
    (yolact ``box_utils.match``), so two gts with one best prior get two
    priors. The rounds run on each gt's top G priors (ties index-ascending,
    the stable ``masked_topk``), which always hold its winner, for the
    whole batch at once. Argmax ties go to the first index, as in
    ``jnp.argmax``."""
    b, g = gt_classes.shape
    n = priors.shape[0]
    dev = gt_boxes.device
    priors_xyxy = box_ops.cxcywh_to_xyxy(priors)
    valid_gt = (gt_classes >= 0) & ~gt_crowd
    overlaps = box_ops.iou_matrix(gt_boxes, priors_xyxy)  # [B, G, N]
    overlaps = torch.where(valid_gt[..., None], overlaps, -1.0)
    best_overlap = overlaps.amax(1)  # [B, N]
    best_idx = overlaps.argmax(1)
    k = min(g, n)
    cand_val, cand_idx, _ = box_ops.masked_topk(
        overlaps, torch.ones_like(overlaps, dtype=torch.bool), k)  # [B, G, k]
    rows = torch.arange(b, device=dev)
    gts = torch.arange(g, device=dev)
    for _ in range(g):
        per_gt_best = cand_val.amax(2)  # [B, G]
        j = per_gt_best.argmax(1)  # [B]
        i = cand_idx[rows, j, cand_val[rows, j].argmax(1)]  # [B]
        ok = per_gt_best[rows, j] >= 0.0  # a valid gt still to claim
        claimed = (cand_idx == i[:, None, None]) | (gts[None, :, None]
                                                    == j[:, None, None])
        cand_val = torch.where(ok[:, None, None] & claimed, -1.0, cand_val)
        best_overlap = best_overlap.scatter(
            1, i[:, None], torch.where(ok[:, None], 2.0,
                                       best_overlap.gather(1, i[:, None])))
        best_idx = best_idx.scatter(
            1, i[:, None], torch.where(ok[:, None], j[:, None],
                                       best_idx.gather(1, i[:, None])))
    conf = gt_classes.gather(1, best_idx).long() + 1
    conf = torch.where(best_overlap < cfg.pos_thresh, -1, conf)
    conf = torch.where(best_overlap < cfg.neg_thresh, 0, conf)
    if g > 0:  # negatives over a crowd become neutral
        crowd_valid = (gt_classes >= 0) & gt_crowd
        crowd_iof = box_ops.iof_matrix(priors_xyxy, gt_boxes,
                                       transpose=True)  # [B, G, N]
        crowd_iof = torch.where(crowd_valid[..., None], crowd_iof, 0.0)
        crowd_hit = crowd_iof.amax(1) > cfg.crowd_iou_threshold
        conf = torch.where((conf <= 0) & crowd_hit, -1, conf)
    matched = box_ops.gather_along_n(gt_boxes, best_idx)  # [B, N, 4]
    return conf, best_idx, box_ops.ssd_encode(matched, priors)


def ohem_conf_loss(conf_logits: torch.Tensor, conf_t: torch.Tensor,
                   cfg: YolactLossConfig) -> torch.Tensor:
    """SSD OHEM: per image, the negatives ranked by log-sum-exp minus the
    background logit (positives and neutrals ranked last), the top
    ``negpos_ratio`` x positives of them (at most N - 1) with the
    positives; the summed cross-entropy. The ranks come from a double
    stable argsort, as ``jnp.argsort``'s."""
    n = conf_logits.shape[1]
    pos = conf_t > 0
    with torch.no_grad():
        x = conf_logits
        mx = x.amax(-1, keepdim=True)
        lse = torch.log(torch.exp(x - mx).sum(-1, keepdim=True)) + mx
        loss_c = (lse - x[..., :1])[..., 0]
        loss_c = torch.where(pos | (conf_t < 0), 0.0, loss_c)
        order = torch.argsort(-loss_c, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        num_neg = (cfg.negpos_ratio * pos.sum(1, keepdim=True)).clamp(
            max=n - 1)
        neg = (rank < num_neg) & (conf_t == 0)
    logp = F.log_softmax(conf_logits, dim=-1)
    ce = -logp.gather(-1, conf_t.clamp(min=0)[..., None].long())[..., 0]
    return cfg.conf_alpha * torch.where(pos | neg, ce, 0.0).sum()


def smooth_l1(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    d = (x - t).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _bce_with_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return F.relu(x) - x * t + torch.log1p(torch.exp(-x.abs()))


def mask_loss(proto: torch.Tensor, coeff: torch.Tensor,
              conf_t: torch.Tensor, matched_idx: torch.Tensor,
              gt_boxes: torch.Tensor, gt_masks_proto: torch.Tensor,
              draws: torch.Tensor, cfg: YolactLossConfig,
              gt_classes: torch.Tensor | None = None):
    """proto [B, S, S, K], coeff [B, N, K], conf_t and matched_idx [B, N],
    gt_boxes [B, G, 4], gt_masks_proto [B, G, S, S] (0/1), ``draws``
    [B, N] uniform in [0, 1) (the JAX package's ``jax.random.uniform`` per
    image; the positives with the largest draws train, up to
    ``masks_to_train``) -> the per-image mask loss [B].

    With ``cfg.use_maskiou`` also the FastMaskIoUNet targets built on the
    same positives (upstream ``lincomb_mask_loss``): ``input`` [B, M, S, S]
    (the sigmoid masks cropped to their gt boxes; not detached, as in the
    JAX package), ``iou_t`` [B, M] (the IoU of the mask binarised at 0.5
    with the gt), ``label`` [B, M] (0-based class), ``valid`` [B, M]."""
    s = proto.shape[1]
    _, sel, sel_valid = box_ops.masked_topk(draws, conf_t > 0,
                                            cfg.masks_to_train)  # [B, M]
    sel_gt = matched_idx.gather(1, sel)
    sel_coeff = box_ops.gather_along_n(coeff, sel)  # [B, M, K]
    mask_t = box_ops.gather_along_n(gt_masks_proto, sel_gt).to(proto.dtype)
    boxes_t = box_ops.gather_along_n(gt_boxes, sel_gt).to(proto.dtype)
    pred = torch.einsum("bhwk,bmk->bmhw", proto, sel_coeff)
    bce = _bce_with_logits(pred, mask_t)
    # the crop of yolact box_utils.crop: the box scaled to the grid, one
    # pixel of padding, clamped; right and bottom edges exclusive
    x1 = (boxes_t[..., 0] * s - 1).clamp(min=0)[..., None, None]
    x2 = (boxes_t[..., 2] * s + 1).clamp(max=s)[..., None, None]
    y1 = (boxes_t[..., 1] * s - 1).clamp(min=0)[..., None, None]
    y2 = (boxes_t[..., 3] * s + 1).clamp(max=s)[..., None, None]
    grid = torch.arange(s, dtype=proto.dtype, device=proto.device)
    rows, cols = grid[:, None], grid[None, :]
    inside = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
    per_inst = torch.where(inside, bce, 0.0).sum((2, 3))
    # divided by the gt box's area in proto pixels
    gt_w = (boxes_t[..., 2] - boxes_t[..., 0]) * s
    gt_h = (boxes_t[..., 3] - boxes_t[..., 1]) * s
    per_inst = per_inst / (gt_w * gt_h).clamp(min=1e-4)
    l_mask = cfg.mask_alpha * torch.where(sel_valid, per_inst, 0.0).sum(1)
    if not cfg.use_maskiou:
        return l_mask
    pred_sig = torch.where(inside, torch.sigmoid(pred), 0.0)
    pred_bin = (pred_sig > 0.5).to(pred.dtype)
    inter = (pred_bin * mask_t).sum((2, 3))
    gt_area = mask_t.sum((2, 3))
    union = pred_bin.sum((2, 3)) + gt_area - inter
    miou = {"input": pred_sig, "iou_t": inter / union.clamp(min=1e-6),
            "label": gt_classes.gather(1, sel_gt).clamp(min=0),
            "valid": sel_valid & (gt_area > cfg.discard_mask_area)}
    return l_mask, miou


def mask_iou_loss(maskiou_net, miou: dict,
                  cfg: YolactLossConfig) -> torch.Tensor:
    """FastMaskIoUNet regression (upstream ``MultiBoxLoss.mask_iou_loss``):
    ``maskiou_net`` maps masks [M, S, S] -> [M, C-1]; ``miou`` is
    :func:`mask_loss`'s, [B, M, ...]."""
    b, m, s, _ = miou["input"].shape
    pred = maskiou_net(miou["input"].reshape(b * m, s, s))
    sel = pred.gather(1, miou["label"].reshape(b * m, 1).long())[:, 0]
    l1 = smooth_l1(sel, miou["iou_t"].reshape(b * m))
    return cfg.maskiou_alpha * torch.where(miou["valid"].reshape(b * m), l1,
                                           0.0).sum()


def semantic_loss(sem_logits: torch.Tensor, gt_classes: torch.Tensor,
                  gt_masks_sem: torch.Tensor, cfg: YolactLossConfig,
                  gt_crowd: torch.Tensor | None = None) -> torch.Tensor:
    """sem_logits [B, Hs, Ws, C-1], gt_masks_sem [B, G, Hs, Ws] (0/1) ->
    the per-image semantic loss [B]: per-class BCE against the union of
    the masks of each class (crowds and padding paint nothing), summed
    and divided by Hs * Ws."""
    _, hs, ws, c = sem_logits.shape
    valid = gt_classes >= 0
    if gt_crowd is not None:
        valid = valid & ~gt_crowd
    # one-hot by comparison (F.one_hot checks its input's range on the
    # host, a synchronisation)
    onehot = ((gt_classes[..., None] == torch.arange(
        c, device=gt_classes.device)) & valid[..., None]).to(sem_logits.dtype)
    # the max over instances of 0/1 masks: whether any instance covers it
    target = (torch.einsum("bghw,bgc->bhwc", gt_masks_sem.to(onehot.dtype),
                           onehot) > 0).to(sem_logits.dtype)
    bce = _bce_with_logits(sem_logits, target)
    return cfg.semantic_alpha * bce.sum((1, 2, 3)) / (hs * ws)


def total_loss(preds: dict, sem_logits: torch.Tensor, targets: dict,
               priors: torch.Tensor, draws: torch.Tensor,
               cfg: YolactLossConfig, maskiou_net=None) -> dict:
    """The batch's loss terms. preds: ``loc`` [B, N, 4], ``conf`` [B, N, C],
    ``coeff`` [B, N, K], ``proto`` [B, S, S, K]; sem_logits [B, Hs, Ws,
    C-1]; targets: ``boxes`` [B, G, 4] (normalised xyxy), ``classes``
    [B, G] (-1 padding), ``crowd`` [B, G], ``masks_proto`` [B, G, S, S],
    ``masks_sem`` [B, G, Hs, Ws]; draws [B, N] uniform (see
    :func:`mask_loss`). -> {"B", "C", "M", "S"[, "I"], "total"}; "I" with
    ``cfg.use_maskiou`` and a ``maskiou_net``."""
    conf_t, midx, loc_t = match_priors(targets["boxes"], targets["classes"],
                                       targets["crowd"], priors, cfg)
    pos = conf_t > 0
    l_loc = torch.where(pos[..., None], smooth_l1(preds["loc"], loc_t),
                        0.0).sum() * cfg.bbox_alpha
    m_ret = mask_loss(preds["proto"], preds["coeff"], conf_t, midx,
                      targets["boxes"], targets["masks_proto"], draws, cfg,
                      gt_classes=targets["classes"])
    l_mask, miou = m_ret if cfg.use_maskiou else (m_ret, None)
    l_sem = semantic_loss(sem_logits, targets["classes"],
                          targets["masks_sem"], cfg, gt_crowd=targets["crowd"])
    l_conf = ohem_conf_loss(preds["conf"], conf_t, cfg)
    total_pos = ddp.denominator(pos.sum(), 1)
    losses = {"B": l_loc / total_pos, "C": l_conf / total_pos,
              "M": l_mask.sum() / total_pos,
              "S": l_sem.sum() / ddp.denominator(preds["loc"].shape[0])}
    if cfg.use_maskiou and maskiou_net is not None:
        losses["I"] = mask_iou_loss(maskiou_net, miou, cfg) / total_pos
    losses["total"] = sum(losses.values())
    return losses
