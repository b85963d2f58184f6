"""Mask R-CNN and Faster R-CNN R-50/101-FPN inference and training forward
(port of ``tpuseg/models/maskrcnn.py``).

ResNet-50 FrozenBN body -> FPN (P2..P6) -> RPN (per-level top-1000, NMS
0.7, top-1000 over levels) -> 7x7 RoIAlign box head (2 FC -> 81-way scores
and class-specific boxes; class-aware NMS 0.5, <= 100 detections) -> 14x14
RoIAlign mask head (4 conv + deconv -> the detected class's 28x28 mask).
``mask_on=False`` is Faster R-CNN: no mask head, boxes only, no mask loss.

The padded contract of the JAX package is kept: nothing is filtered, only
ranked and masked, so every output has a fixed shape ([B, 100] plus
``valid``, masks [B, 100, 28, 28]). Module attribute paths are the
maskrcnn-benchmark state_dict keys. Tensors are NCHW; the canvas is the
static padded image of the JAX package, and anchors whose grid cell lies
outside an image's real extent are masked out.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.core import boxes as box_ops
from tpuseg_torch.models import maskrcnn_loss as ML
from tpuseg_torch.nn.fpn import FPN, Backbone
from tpuseg_torch.nn.layers import FrozenBatchNorm2d
from tpuseg_torch.nn.resnet import ResNet
from tpuseg_torch.ops import nms as nms_ops
from tpuseg_torch.ops import sampling


@dataclass(frozen=True)
class MaskRCNNConfig:
    """The JAX ``MaskRCNNConfig``'s fields for the FPN Mask R-CNN (same
    defaults)."""
    depth: int = 50
    freeze_at: int = 2
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    anchor_stride: tuple = (4, 8, 16, 32, 64)
    rpn_pre_nms_top_n: int = 1000
    rpn_post_nms_top_n: int = 1000
    rpn_nms_thresh: float = 0.7
    fpn_post_nms_top_n: int = 1000
    # train-time proposal budget (maskrcnn-benchmark *_TRAIN knobs)
    rpn_pre_nms_top_n_train: int = 2000
    fpn_post_nms_top_n_train: int = 2000
    # FPN_POST_NMS_PER_BATCH (upstream's training default): the post-NMS
    # top-n over the whole batch, not per image; forward_train_losses sets it
    fpn_post_nms_per_batch: bool = False
    num_classes: int = 81
    pooler_resolution: int = 7
    pooler_sampling_ratio: int = 2
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    box_reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    pre_final_nms_topk: int = 2048  # static cap on class-box candidates
    # mask head; mask_on=False is the Faster R-CNN configuration
    # (MODEL.MASK_ON in the e2e_faster_rcnn_*.yaml family)
    mask_on: bool = True
    mask_resolution: int = 14
    mask_out: int = 28
    fpn_channels: int = 256


# ---------------------------------------------------------------------------
# Anchors (copied from the JAX package: plain numpy)
# ---------------------------------------------------------------------------


def _generate_cell_anchors(size: float, ratios, base: float) -> np.ndarray:
    """One stride's A anchors at the cell origin (Caffe2 generate_anchors)."""
    stride = base
    anchor = np.array([1, 1, stride, stride], np.float64) - 1
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    x_ctr = anchor[0] + 0.5 * (w - 1)
    y_ctr = anchor[1] + 0.5 * (h - 1)
    size_ratios = w * h / np.asarray(ratios, np.float64)
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * np.asarray(ratios, np.float64))
    anchors = np.stack([x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                        x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)], axis=1)
    scale = size / stride
    out = []
    for a in anchors:
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        xc = a[0] + 0.5 * (w - 1)
        yc = a[1] + 0.5 * (h - 1)
        ws = w * scale
        hs = h * scale
        out.append([xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                    xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)])
    return np.asarray(out, np.float64)


def fpn_level_hw(h: int, w: int, stride: int) -> tuple:
    """Feature extent at a level: successive ceil-halvings == ceil(n/stride)."""
    return -(-h // stride), -(-w // stride)


@functools.lru_cache(maxsize=16)
def make_anchors_np(cfg: MaskRCNNConfig, canvas_h: int, canvas_w: int):
    """Per-level anchors [Hl*Wl*A, 4] over the static canvas."""
    out = []
    for size, stride in zip(cfg.anchor_sizes, cfg.anchor_stride):
        cell = _generate_cell_anchors(size, cfg.anchor_ratios, base=stride)
        hl, wl = fpn_level_hw(canvas_h, canvas_w, stride)
        shift_x, shift_y = np.meshgrid(np.arange(wl) * stride,
                                       np.arange(hl) * stride)
        shifts = np.stack([shift_x.ravel(), shift_y.ravel(),
                           shift_x.ravel(), shift_y.ravel()], 1)
        anchors = (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)
        out.append(anchors.astype(np.float32))
    return out


@functools.lru_cache(maxsize=16)
def _anchors_on(cfg: MaskRCNNConfig, canvas_h: int, canvas_w: int,
                device: torch.device) -> tuple:
    return tuple(torch.from_numpy(a).to(device)
                 for a in make_anchors_np(cfg, canvas_h, canvas_w))


# ---------------------------------------------------------------------------
# Modules (attribute paths = maskrcnn-benchmark state_dict keys)
# ---------------------------------------------------------------------------


class RPNHead(nn.Module):
    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: list):
        """-> per level: logits [B, H*W*A], deltas [B, H*W*A, 4], flattened
        in the (H, W, A) order of :func:`make_anchors_np`."""
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            b = t.shape[0]
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(self.bbox_pred(t).permute(0, 2, 3, 1)
                          .reshape(b, -1, 4))
        return logits, deltas


class RPN(nn.Module):
    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.head = RPNHead(channels, num_anchors)


class BoxFeatureExtractor(nn.Module):
    def __init__(self, in_features: int, hidden: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(in_features, hidden)
        self.fc7 = nn.Linear(hidden, hidden)


class BoxPredictor(nn.Module):
    def __init__(self, hidden: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(hidden, num_classes)
        self.bbox_pred = nn.Linear(hidden, num_classes * 4)


class BoxHead(nn.Module):
    def __init__(self, channels: int, resolution: int, num_classes: int):
        super().__init__()
        self.feature_extractor = BoxFeatureExtractor(
            channels * resolution * resolution)
        self.predictor = BoxPredictor(1024, num_classes)

    def forward(self, pooled: torch.Tensor):
        """[N, C, 7, 7] -> (class logits [N, K], box deltas [N, K*4])."""
        fe, pr = self.feature_extractor, self.predictor
        x = F.relu(fe.fc6(pooled.flatten(1)))
        x = F.relu(fe.fc7(x))
        return pr.cls_score(x), pr.bbox_pred(x)


class MaskFeatureExtractor(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"mask_fcn{i}",
                            nn.Conv2d(channels, channels, 3, padding=1))


class MaskPredictor(nn.Module):
    """Upstream ``MaskRCNNC4Predictor``: a stride-2 deconv from
    ``in_channels`` (256 after the FPN mask head's convs, 2048 after C4's
    res5) to ``channels``, then a 1x1 conv to the class logits."""

    def __init__(self, in_channels: int, channels: int, num_classes: int):
        super().__init__()
        self.conv5_mask = nn.ConvTranspose2d(in_channels, channels, 2,
                                             stride=2)
        self.mask_fcn_logits = nn.Conv2d(channels, num_classes, 1)

    def forward(self, x: torch.Tensor, class_sel: torch.Tensor):
        """[N, in, R, R] -> [N, 2R, 2R] logits of class ``class_sel[n]``
        only: the 1x1 conv's row for that class in x's dtype, as the JAX
        heads compute it (the same values as slicing the full [N, K, 2R,
        2R] output)."""
        x = F.relu(self.conv5_mask(x))
        logits = self.mask_fcn_logits
        wsel = logits.weight[class_sel, :, 0, 0].to(x.dtype)  # [N, C]
        return (torch.einsum("nchw,nc->nhw", x, wsel)
                + logits.bias[class_sel].to(x.dtype)[:, None, None])


class MaskHead(nn.Module):
    def __init__(self, channels: int, num_classes: int):
        super().__init__()
        self.feature_extractor = MaskFeatureExtractor(channels)
        self.predictor = MaskPredictor(channels, channels, num_classes)

    def forward(self, pooled: torch.Tensor, class_sel: torch.Tensor):
        """[N, C, 14, 14] -> [N, 28, 28] logits of class ``class_sel[n]``
        (the JAX ``mask_head(class_sel=...)``)."""
        x = pooled
        for i in range(1, 5):
            x = F.relu(getattr(self.feature_extractor, f"mask_fcn{i}")(x))
        return self.predictor(x, class_sel)


class ROIHeads(nn.Module):
    def __init__(self, cfg: MaskRCNNConfig):
        super().__init__()
        self.box = BoxHead(cfg.fpn_channels, cfg.pooler_resolution,
                           cfg.num_classes)
        if cfg.mask_on:
            self.mask = MaskHead(cfg.fpn_channels, cfg.num_classes)


class MaskRCNN(nn.Module):
    """``backbone`` (body + fpn), ``rpn``, ``roi_heads``; ``cfg`` rides along."""

    def __init__(self, cfg: MaskRCNNConfig = MaskRCNNConfig()):
        super().__init__()
        self.cfg = cfg
        body = ResNet(cfg.depth, freeze_at=cfg.freeze_at)
        self.backbone = Backbone(body, FPN(body.out_channels, cfg.fpn_channels))
        self.rpn = RPN(cfg.fpn_channels, len(cfg.anchor_ratios))
        self.roi_heads = ROIHeads(cfg)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``: conv/linear weights N(0, 1/fan_in),
    biases 0, FrozenBN as the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                w.normal_(0.0, w[0].numel() ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FrozenBatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model


def build_model(cfg: MaskRCNNConfig = MaskRCNNConfig(),
                generator: torch.Generator | None = None) -> MaskRCNN:
    """A CPU model: random weights from ``generator`` if one is given,
    otherwise uninitialised storage for ``load_state_dict`` to fill."""
    with torch.device("meta"):
        model = MaskRCNN(cfg)
    model = model.to_empty(device="cpu")
    if generator is not None:
        init_weights(model, generator)
    return model.eval()


# ---------------------------------------------------------------------------
# RPN proposals (rpn/inference.py)
# ---------------------------------------------------------------------------


def anchor_inside_mask(image_hw: torch.Tensor, stride: int, hl: int, wl: int,
                       num_anchors: int) -> torch.Tensor:
    """[B, hl*wl*A]: anchors whose grid cell lies inside the real (unpadded)
    feature extent of each image."""
    b = image_hw.shape[0]
    dev = image_hw.device
    gy = torch.arange(hl, device=dev)[:, None]
    gx = torch.arange(wl, device=dev)[None, :]
    real_h = -(-image_hw[:, 0] // stride)
    real_w = -(-image_hw[:, 1] // stride)
    inside = ((gy[None] < real_h[:, None, None])
              & (gx[None] < real_w[:, None, None]))  # [B, hl, wl]
    return inside.reshape(b, -1).repeat_interleave(num_anchors, dim=1)


def _clip_per_image(boxes: torch.Tensor, image_hw: torch.Tensor):
    """Clip [B, ..., 4] boxes to each image's (h - 1, w - 1)."""
    shape = (-1,) + (1,) * (boxes.ndim - 2)
    return box_ops.clip_to_image(boxes, (image_hw[:, 0] - 1).reshape(shape),
                                 (image_hw[:, 1] - 1).reshape(shape))


def rpn_proposals(logits: list, deltas: list, anchors, image_hw: torch.Tensor,
                  cfg: MaskRCNNConfig, canvas_hw: tuple):
    """-> (proposals [B, P, 4], scores [B, P], valid [B, P]); P = fpn top n.

    Per level: masked top-k of the objectness logits (k = min(1000, n): P6
    at 800x1344 has only 819 anchors), decode, clip, NMS 0.7 with +1
    extents; then the top P survivors over all levels (with
    ``fpn_post_nms_per_batch``, only those at or above the batch-wide P-th
    score, upstream's select_over_all_levels in training). Upstream's
    remove_small_boxes keeps every box at its MIN_SIZE of 0, so it is not
    ported.
    """
    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    for li, (lg, dl, an) in enumerate(zip(logits, deltas, anchors)):
        stride = cfg.anchor_stride[li]
        hl, wl = fpn_level_hw(canvas_hw[0], canvas_hw[1], stride)
        inside = anchor_inside_mask(image_hw, stride, hl, wl,
                                    an.shape[0] // (hl * wl))
        k = min(cfg.rpn_pre_nms_top_n, lg.shape[1])
        _, idx, top_valid = box_ops.masked_topk(lg, inside, k)
        boxes = box_ops.decode_boxes(box_ops.gather_along_n(dl, idx), an[idx],
                                     weights=(1.0, 1.0, 1.0, 1.0))
        boxes = _clip_per_image(boxes, image_hw)
        scores = torch.gather(torch.sigmoid(lg), 1, idx)
        keep = nms_ops.nms_mask_batch(boxes, scores, cfg.rpn_nms_thresh,
                                      valid=top_valid, to_remove=1.0)
        lvl_boxes.append(boxes)
        lvl_scores.append(torch.where(keep, scores, torch.zeros_like(scores)))
        lvl_valid.append(keep)
    all_boxes = torch.cat(lvl_boxes, 1)
    all_scores = torch.cat(lvl_scores, 1)
    all_valid = torch.cat(lvl_valid, 1)
    if cfg.fpn_post_nms_per_batch:
        # a batch-wide gate at the k-th score keeps the padded [B, P] shape;
        # the per-image top-k below then passes all that survive it
        k = min(cfg.fpn_post_nms_top_n, all_scores.numel())
        flat = all_scores.masked_fill(~all_valid, float("-inf")).reshape(-1)
        all_valid = all_valid & (all_scores >= torch.topk(flat, k).values[-1])
    top_s, idx, valid = box_ops.masked_topk(all_scores, all_valid,
                                            cfg.fpn_post_nms_top_n)
    return box_ops.gather_along_n(all_boxes, idx), top_s, valid


# ---------------------------------------------------------------------------
# FPN pooler (poolers.py LevelMapper + RoIAlign)
# ---------------------------------------------------------------------------


def assign_levels(boxes: torch.Tensor, k_min=2, k_max=5, canonical_scale=224,
                  canonical_level=4, eps=1e-6) -> torch.Tensor:
    """LevelMapper on sqrt(area) with +1 extents (BoxList.area): 0..3."""
    s = torch.sqrt(box_ops.area(boxes, to_remove=1.0))
    lvl = torch.floor(canonical_level + torch.log2(s / canonical_scale + eps))
    return lvl.clamp(k_min, k_max).to(torch.int32) - k_min


def pooled_roi_features(feats: list, boxes: torch.Tensor,
                        batch_idx: torch.Tensor, resolution: int,
                        sampling_ratio: int, strides=(4, 8, 16, 32)):
    """Multi-level RoIAlign, each box from its assigned level (after the
    reference's window clamp) -> [N, C, R, R]."""
    levels = assign_levels(boxes)
    levels = sampling.clamp_levels_to_window(feats, boxes, levels, strides)
    return sampling.multilevel_roi_align(feats, boxes, batch_idx, levels,
                                         resolution, sampling_ratio, strides)


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------


def forward_heads(model: MaskRCNN, pyramid: list, image_hw: torch.Tensor,
                  canvas_hw: tuple) -> dict:
    """Everything after the backbone: RPN, box head, class-aware NMS and
    mask head, on the pyramid [P2..P6] of a [B, 3, *canvas_hw] batch."""
    cfg = model.cfg
    b = pyramid[0].shape[0]
    dev = pyramid[0].device
    logits, deltas = model.rpn.head(pyramid)
    anchors = _anchors_on(cfg, canvas_hw[0], canvas_hw[1], dev)
    proposals, _, p_valid = rpn_proposals(logits, deltas, anchors, image_hw,
                                          cfg, canvas_hw)
    # both poolers read P2..P5; one layout change serves both
    feats = [f.contiguous(memory_format=torch.channels_last)
             for f in pyramid[:4]]

    # ---- box head over B*P rois
    p = proposals.shape[1]
    nc = cfg.num_classes
    pooled = pooled_roi_features(
        feats, proposals.reshape(b * p, 4),
        torch.arange(b, device=dev).repeat_interleave(p),
        cfg.pooler_resolution, cfg.pooler_sampling_ratio)
    cls_logits, box_deltas = model.roi_heads.box(pooled)
    scores = torch.softmax(cls_logits, -1).reshape(b, p, nc)
    decoded = box_ops.decode_boxes(box_deltas.reshape(b, p, nc * 4), proposals,
                                   weights=cfg.box_reg_weights)
    decoded = _clip_per_image(decoded.reshape(b, p, nc, 4)[:, :, 1:], image_hw)
    cls_scores = scores[:, :, 1:]  # [B, P, K-1], background dropped
    # upstream PostProcessor filters on score only (no size filter); the
    # candidates are the flattened [P, K-1] array: k -> (k // (K-1), k % (K-1))
    cand_valid = p_valid[:, :, None] & (cls_scores > cfg.score_thresh)
    flat_c = torch.arange(nc - 1, device=dev).repeat(p)
    top_s, sel, sel_valid = box_ops.masked_topk(
        cls_scores.reshape(b, -1), cand_valid.reshape(b, -1),
        cfg.pre_final_nms_topk)
    cboxes = box_ops.gather_along_n(decoded.reshape(b, -1, 4), sel)
    cclasses = flat_c[sel]
    keep = nms_ops.batched_nms_mask_batch(cboxes, top_s, cclasses,
                                          cfg.nms_thresh, valid=sel_valid,
                                          to_remove=1.0)
    neg = torch.full_like(top_s, float("-inf"))
    fin_s, fidx, fvalid = box_ops.masked_topk(torch.where(keep, top_s, neg),
                                              keep, cfg.detections_per_img)
    det_boxes = box_ops.gather_along_n(cboxes, fidx)
    out = {
        "boxes": det_boxes,
        "scores": torch.where(fvalid, fin_s, torch.zeros_like(fin_s)),
        "classes": torch.gather(cclasses, 1, fidx),  # 0-based, no background
        "valid": fvalid,
        "proposals": proposals,
        "proposal_valid": p_valid,
        "candidate_valid": sel_valid,  # inputs of the final NMS
    }
    if not cfg.mask_on:  # Faster R-CNN: boxes only
        return out

    # ---- mask head on the detections
    d = cfg.detections_per_img
    mask_pooled = pooled_roi_features(
        feats, det_boxes.reshape(b * d, 4),
        torch.arange(b, device=dev).repeat_interleave(d),
        cfg.mask_resolution, cfg.pooler_sampling_ratio)
    masks = model.roi_heads.mask(mask_pooled,
                                 (out["classes"] + 1).reshape(b * d))
    out["masks"] = torch.sigmoid(masks).reshape(b, d, cfg.mask_out,
                                                cfg.mask_out)
    return out


def forward_inference(model: MaskRCNN, images: torch.Tensor,
                      image_hw: torch.Tensor) -> dict:
    """images [B, 3, Hc, Wc] preprocessed on the static canvas; image_hw
    [B, 2] int real sizes -> dict of padded detections (see module doc)."""
    pyramid = model.backbone(images)
    return forward_heads(model, pyramid, image_hw, tuple(images.shape[-2:]))


# ---------------------------------------------------------------------------
# Training forward (GeneralizedRCNN.forward with targets)
# ---------------------------------------------------------------------------


def _uniform_pairs(b: int, n: int, generator, dev) -> list:
    return [(torch.rand(n, generator=generator, device=dev),
             torch.rand(n, generator=generator, device=dev)) for _ in range(b)]


def forward_train_losses(model: MaskRCNN, images: torch.Tensor,
                         image_hw: torch.Tensor, targets: dict,
                         generator: torch.Generator | None = None,
                         draws: dict | None = None, loss_cfg=None) -> dict:
    """One training forward -> the reference's five losses and ``total``
    (port of ``tpuseg/models/maskrcnn.py::forward_train_losses``).

    images [B, 3, Hc, Wc] on the canvas, image_hw [B, 2] real sizes;
    targets: ``boxes`` [B, G, 4] canvas coordinates, ``classes`` [B, G]
    (0-based, -1 pads), ``mask_crops`` [B, G, R, R] float gt masks over
    their boxes. The samplers' uniform draws come from ``draws`` if given,
    ``{"rpn": [(pos, neg)] * B, "roi": [(pos, neg)] * B}`` with vectors of
    the number of anchors and of proposals + G, else from ``generator`` (on
    the images' device; None = its default generator), RPN then RoI, per
    image positives then negatives. ``mask_crops`` is not read when
    ``mask_on`` is False (Faster R-CNN: four losses and ``total``).

    The RPN outputs are detached before proposal generation, which runs
    without autograd (upstream passes them ``.detach()``-ed); proposals use
    the train budgets and the batch-wide top-n. 512 rois per image feed the
    box head; only the first 128 sampled slots, which hold every positive,
    feed the mask head.
    """
    cfg = model.cfg
    if loss_cfg is None:
        loss_cfg = ML.MaskRCNNLossConfig(num_classes=cfg.num_classes)
    b = images.shape[0]
    canvas = tuple(images.shape[-2:])
    dev = images.device
    pyramid = model.backbone(images)
    logits, deltas = model.rpn.head(pyramid)
    anchors_l = _anchors_on(cfg, canvas[0], canvas[1], dev)
    anchors = torch.cat(anchors_l)
    gt_boxes, gt_classes = targets["boxes"], targets["classes"]
    gt_valid = gt_classes >= 0
    inside = []
    for li, an in enumerate(anchors_l):
        stride = cfg.anchor_stride[li]
        hl, wl = fpn_level_hw(canvas[0], canvas[1], stride)
        inside.append(anchor_inside_mask(image_hw, stride, hl, wl,
                                         an.shape[0] // (hl * wl)))
    rpn_draws = (draws["rpn"] if draws is not None else
                 _uniform_pairs(b, anchors.shape[0], generator, dev))
    losses = ML.rpn_loss(torch.cat([lg.float() for lg in logits], 1),
                         torch.cat([dl.float() for dl in deltas], 1), anchors,
                         gt_boxes, gt_valid, rpn_draws, loss_cfg,
                         image_hw=image_hw, anchor_inside=torch.cat(inside, 1))

    train_cfg = replace(cfg, rpn_pre_nms_top_n=cfg.rpn_pre_nms_top_n_train,
                        fpn_post_nms_top_n=cfg.fpn_post_nms_top_n_train,
                        fpn_post_nms_per_batch=True)
    with torch.no_grad():
        proposals, _, p_valid = rpn_proposals(
            [lg.detach() for lg in logits], [dl.detach() for dl in deltas],
            anchors_l, image_hw, train_cfg, canvas)
    roi_draws = (draws["roi"] if draws is not None else _uniform_pairs(
        b, proposals.shape[1] + gt_boxes.shape[1], generator, dev))
    per_image = [ML.sample_proposals(proposals[i], p_valid[i], gt_boxes[i],
                                     gt_classes[i], gt_valid[i],
                                     *roi_draws[i], loss_cfg)
                 for i in range(b)]
    sample = {k: torch.stack([s_[k] for s_ in per_image]) for k in per_image[0]}

    # both poolers read P2..P5; one layout change serves both, and its
    # backward sums their gradients
    feats = [f.contiguous(memory_format=torch.channels_last)
             for f in pyramid[:4]]
    s = sample["boxes"].shape[1]
    pooled = pooled_roi_features(
        feats, sample["boxes"].reshape(b * s, 4),
        torch.arange(b, device=dev).repeat_interleave(s),
        cfg.pooler_resolution, cfg.pooler_sampling_ratio)
    cls_logits, box_deltas = model.roi_heads.box(pooled)
    flat = {k: v.reshape((b * s,) + v.shape[2:]) for k, v in sample.items()}
    losses.update(ML.box_head_loss(cls_logits.float(), box_deltas.float(),
                                   flat, loss_cfg))
    if not cfg.mask_on:  # Faster R-CNN: no mask loss
        losses["total"] = sum(losses.values())
        return losses

    m = int(loss_cfg.roi_batch_per_image * loss_cfg.roi_pos_fraction)
    mask_boxes = sample["boxes"][:, :m]
    mask_pooled = pooled_roi_features(
        feats, mask_boxes.reshape(b * m, 4),
        torch.arange(b, device=dev).repeat_interleave(m),
        cfg.mask_resolution, cfg.pooler_sampling_ratio)
    msample = {k: v[:, :m].reshape((b * m,) + v.shape[2:])
               for k, v in sample.items()}
    mask_x = model.roi_heads.mask(mask_pooled, msample["cls_target"])
    t28 = torch.stack([ML.mask_targets_from_crops(
        mask_boxes[i], sample["gt_idx"][i, :m], gt_boxes[i],
        targets["mask_crops"][i], cfg.mask_out) for i in range(b)])
    losses.update(ML.mask_head_loss_selected(
        mask_x.float(), msample, t28.reshape(b * m, cfg.mask_out, cfg.mask_out),
        loss_cfg))
    losses["total"] = sum(losses.values())
    return losses
