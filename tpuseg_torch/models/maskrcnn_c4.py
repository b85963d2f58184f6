"""Mask R-CNN and Faster R-CNN R-50/101-C4 inference and training forward
(port of ``tpuseg/models/maskrcnn_c4.py``; ``e2e_mask_rcnn_R_50_C4_1x.yaml``,
the configuration upstream's README demos first).

ResNet stem + layer1-3 -> C4 (stride 16, 1024 channels) -> a single-level
RPN with 15 anchors a cell (5 sizes x 3 ratios, ratio-major) -> 14x14
RoIAlign on the adaptive grid -> res5 (layer4) as the box feature
extractor -> global average pool -> 81-way scores and class-specific boxes;
the mask head runs res5 again on the detections and predicts the detected
class's 14x14 mask (deconv 2048 -> 256, then a 1x1 conv). ``mask_on=False``
is Faster R-CNN C4.

The padded contract of :mod:`tpuseg_torch.models.maskrcnn` is kept. Module
paths are the maskrcnn-benchmark keys: ``backbone.body.*``, ``rpn.head.*``,
``roi_heads.box.feature_extractor.head.layer4.*``,
``roi_heads.box.predictor.*``, ``roi_heads.mask.predictor.*`` (upstream's
shared extractor also saves layer4 under ``roi_heads.mask.
feature_extractor.*``; the loader drops that copy after checking it).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from tpuseg_torch.core import boxes as box_ops
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import maskrcnn_loss as ML
from tpuseg_torch.nn.resnet import ResNet, ResNetHead
from tpuseg_torch.ops import nms as nms_ops
from tpuseg_torch.ops.sampling import roi_align


@dataclass(frozen=True)
class MaskRCNNC4Config:
    """The JAX ``MaskRCNNC4Config`` (same fields and defaults)."""
    depth: int = 50
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    anchor_stride: int = 16
    rpn_pre_nms_top_n: int = 6000
    rpn_post_nms_top_n: int = 1000
    # the train-time RPN budgets of upstream's defaults (the C4 yamls keep
    # them)
    rpn_pre_nms_top_n_train: int = 12000
    rpn_post_nms_top_n_train: int = 2000
    rpn_nms_thresh: float = 0.7
    num_classes: int = 81
    pooler_resolution: int = 14
    # 0: the adaptive ceil(roi / P) grid, upstream's default that the C4
    # yamls inherit
    pooler_sampling_ratio: int = 0
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    box_reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    pre_final_nms_topk: int = 2048
    mask_on: bool = True  # False: Faster R-CNN C4
    mask_out: int = 14


@functools.lru_cache(maxsize=8)
def make_anchors_np(cfg: MaskRCNNC4Config, canvas_h: int, canvas_w: int):
    """[Hl*Wl*15, 4] anchors over the C4 map of the canvas; the cell's 15
    in ratio-major order (Caffe2's _ratio_enum, then _scale_enum for each
    ratio), the order of the RPN head's channels in upstream's
    checkpoints."""
    cells = [M._generate_cell_anchors(s, cfg.anchor_ratios,
                                      base=cfg.anchor_stride)
             for s in cfg.anchor_sizes]  # [size][ratio, 4]
    cell = np.stack(cells, axis=0).transpose(1, 0, 2).reshape(-1, 4)
    hl, wl = M.fpn_level_hw(canvas_h, canvas_w, cfg.anchor_stride)
    shift_x, shift_y = np.meshgrid(np.arange(wl) * cfg.anchor_stride,
                                   np.arange(hl) * cfg.anchor_stride)
    shifts = np.stack([shift_x.ravel(), shift_y.ravel(), shift_x.ravel(),
                       shift_y.ravel()], 1)
    return (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4).astype(
        np.float32)


@functools.lru_cache(maxsize=8)
def _anchors_on(cfg: MaskRCNNC4Config, canvas_h: int, canvas_w: int,
                device: torch.device) -> torch.Tensor:
    return torch.from_numpy(make_anchors_np(cfg, canvas_h, canvas_w)).to(
        device)


# ---------------------------------------------------------------------------
# Modules (attribute paths = maskrcnn-benchmark state_dict keys)
# ---------------------------------------------------------------------------


class C4Backbone(nn.Module):
    """``backbone.body``: images -> C4 [B, 1024, H/16, W/16]. The stem and
    layer1 are frozen (FREEZE_CONV_BODY_AT 2)."""

    def __init__(self, depth: int):
        super().__init__()
        self.body = ResNet(depth, freeze_at=2, num_stages=3)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.body(images)[-1]


class C4BoxFeatureExtractor(nn.Module):
    def __init__(self, depth: int, in_channels: int):
        super().__init__()
        self.head = ResNetHead(depth, in_channels)


class C4BoxHead(nn.Module):
    def __init__(self, depth: int, in_channels: int, num_classes: int):
        super().__init__()
        self.feature_extractor = C4BoxFeatureExtractor(depth, in_channels)
        self.predictor = M.BoxPredictor(
            self.feature_extractor.head.out_channels, num_classes)

    def forward(self, pooled: torch.Tensor):
        """[N, 1024, 14, 14] -> (class logits [N, K], box deltas [N, K*4],
        the res5 features [N, 2048, 7, 7]) at R-50's widths."""
        feats = self.feature_extractor.head(pooled)
        x = feats.mean(dim=(2, 3))
        return self.predictor.cls_score(x), self.predictor.bbox_pred(x), feats


class C4MaskHead(nn.Module):
    """The mask predictor on res5's features (the box head's extractor is
    shared, SHARE_BOX_FEATURE_EXTRACTOR)."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.predictor = M.MaskPredictor(in_channels, 256, num_classes)


class C4ROIHeads(nn.Module):
    """The heads on the C4 body's ``in_channels``-channel map."""

    def __init__(self, cfg: MaskRCNNC4Config, in_channels: int):
        super().__init__()
        self.box = C4BoxHead(cfg.depth, in_channels, cfg.num_classes)
        if cfg.mask_on:
            self.mask = C4MaskHead(
                self.box.feature_extractor.head.out_channels,
                cfg.num_classes)


class MaskRCNNC4(nn.Module):
    """``backbone``, ``rpn``, ``roi_heads``; ``cfg`` rides along."""

    def __init__(self, cfg: MaskRCNNC4Config = MaskRCNNC4Config()):
        super().__init__()
        self.cfg = cfg
        self.backbone = C4Backbone(cfg.depth)
        c4 = self.backbone.body.out_channels[-1]
        self.rpn = M.RPN(c4, len(cfg.anchor_sizes) * len(cfg.anchor_ratios))
        self.roi_heads = C4ROIHeads(cfg, c4)


def build_model(cfg: MaskRCNNC4Config = MaskRCNNC4Config(),
                generator: torch.Generator | None = None) -> MaskRCNNC4:
    """A CPU model: random weights from ``generator`` (as
    :func:`tpuseg_torch.models.maskrcnn.init_weights`) if one is given,
    otherwise uninitialised storage for ``load_state_dict`` to fill."""
    with torch.device("meta"):
        model = MaskRCNNC4(cfg)
    model = model.to_empty(device="cpu")
    if generator is not None:
        M.init_weights(model, generator)
    return model.eval()


def _single_level_cfg(cfg: MaskRCNNC4Config, train: bool = False
                      ) -> M.MaskRCNNConfig:
    """An FPN config with one level, so that the C4 RPN runs
    :func:`tpuseg_torch.models.maskrcnn.rpn_proposals`: the inference or
    the train budgets, the post-NMS top-n per image."""
    pre = cfg.rpn_pre_nms_top_n_train if train else cfg.rpn_pre_nms_top_n
    post = cfg.rpn_post_nms_top_n_train if train else cfg.rpn_post_nms_top_n
    return M.MaskRCNNConfig(
        rpn_pre_nms_top_n=pre, rpn_post_nms_top_n=post,
        rpn_nms_thresh=cfg.rpn_nms_thresh, fpn_post_nms_top_n=post,
        fpn_post_nms_per_batch=False, anchor_stride=(cfg.anchor_stride,),
        anchor_ratios=tuple(r for _ in cfg.anchor_sizes
                            for r in cfg.anchor_ratios))


def pooled_rois(cfg: MaskRCNNC4Config, c4: torch.Tensor,
                boxes: torch.Tensor) -> torch.Tensor:
    """The C4 pooler: boxes [B, R, 4] -> [B*R, 1024, 14, 14], RoIAlign at
    1/16 on the configured grid (adaptive by default), in its separable
    form."""
    b, r = boxes.shape[:2]
    return roi_align(c4, boxes.reshape(b * r, 4),
                     torch.arange(b, device=c4.device).repeat_interleave(r),
                     output_size=cfg.pooler_resolution,
                     spatial_scale=1.0 / cfg.anchor_stride,
                     sampling_ratio=cfg.pooler_sampling_ratio, group_size=r)


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------


def forward_heads(model: MaskRCNNC4, c4: torch.Tensor,
                  image_hw: torch.Tensor, canvas_hw: tuple) -> dict:
    """Everything after the body: RPN, box head, class-aware NMS and mask
    head, on the C4 map of a [B, 3, *canvas_hw] batch."""
    cfg = model.cfg
    b = c4.shape[0]
    dev = c4.device
    logits, deltas = model.rpn.head([c4])
    anchors = _anchors_on(cfg, canvas_hw[0], canvas_hw[1], dev)
    proposals, _, p_valid = M.rpn_proposals(logits, deltas, [anchors],
                                            image_hw, _single_level_cfg(cfg),
                                            canvas_hw)

    p = proposals.shape[1]
    nc = cfg.num_classes
    cls_logits, box_deltas, _ = model.roi_heads.box(
        pooled_rois(cfg, c4, proposals))
    scores = torch.softmax(cls_logits.float(), -1).reshape(b, p, nc)
    decoded = box_ops.decode_boxes(box_deltas.float().reshape(b, p, nc * 4),
                                   proposals, weights=cfg.box_reg_weights)
    decoded = M._clip_per_image(decoded.reshape(b, p, nc, 4)[:, :, 1:],
                                image_hw)
    cls_scores = scores[:, :, 1:]
    cand_valid = p_valid[:, :, None] & (cls_scores > cfg.score_thresh)
    top_s, sel, sel_valid = box_ops.masked_topk(
        cls_scores.reshape(b, -1), cand_valid.reshape(b, -1),
        cfg.pre_final_nms_topk)
    cboxes = box_ops.gather_along_n(decoded.reshape(b, -1, 4), sel)
    cclasses = torch.arange(nc - 1, device=dev).repeat(p)[sel]
    # the JAX C4 path runs the per-image offset of batched_nms_mask
    keep = nms_ops.batched_nms_mask(cboxes, top_s, cclasses, cfg.nms_thresh,
                                    valid=sel_valid, to_remove=1.0)
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
    if not cfg.mask_on:  # Faster R-CNN C4: boxes only
        return out

    # mask head: res5 again on the detections, the detected class's column
    d = cfg.detections_per_img
    mfeats = model.roi_heads.box.feature_extractor.head(
        pooled_rois(cfg, c4, det_boxes))
    masks = model.roi_heads.mask.predictor(
        mfeats, (out["classes"] + 1).reshape(b * d))
    out["masks"] = torch.sigmoid(masks.float()).reshape(b, d, cfg.mask_out,
                                                        cfg.mask_out)
    return out


def forward_inference(model: MaskRCNNC4, images: torch.Tensor,
                      image_hw: torch.Tensor) -> dict:
    """images [B, 3, Hc, Wc] preprocessed on the static canvas; image_hw
    [B, 2] real sizes -> padded detections (``masks`` [B, 100, 14, 14]
    when ``mask_on``)."""
    return forward_heads(model, model.backbone(images), image_hw,
                         tuple(images.shape[-2:]))


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def forward_train_losses(model: MaskRCNNC4, images: torch.Tensor,
                         image_hw: torch.Tensor, targets: dict,
                         generator: torch.Generator | None = None,
                         draws: dict | None = None, loss_cfg=None) -> dict:
    """One C4 training forward -> the reference's five losses and
    ``total`` (four without ``mask_on``); port of
    ``tpuseg/models/maskrcnn_c4.py::forward_train_losses``. Inputs, targets
    and draws as :func:`tpuseg_torch.models.maskrcnn.forward_train_losses`.

    The differences from the FPN path: the single-level RPN with the C4
    train budgets (12 000 before NMS, 2000 after, per image); RoIAlign 14x14
    off C4 on the adaptive grid; res5 as the box head's extractor, shared
    with the mask predictor (which reads the res5 features of the first
    ``roi_batch_per_image * roi_pos_fraction`` sampled rois, where every
    positive lies); 14x14 mask targets.
    """
    cfg = model.cfg
    if loss_cfg is None:
        loss_cfg = ML.MaskRCNNLossConfig(num_classes=cfg.num_classes,
                                         mask_size=cfg.mask_out)
    b = images.shape[0]
    canvas = tuple(images.shape[-2:])
    dev = images.device
    c4 = model.backbone(images)
    logits, deltas = model.rpn.head([c4])
    anchors = _anchors_on(cfg, canvas[0], canvas[1], dev)
    hl, wl = M.fpn_level_hw(canvas[0], canvas[1], cfg.anchor_stride)
    inside = M.anchor_inside_mask(image_hw, cfg.anchor_stride, hl, wl,
                                  anchors.shape[0] // (hl * wl))
    gt_boxes, gt_classes = targets["boxes"], targets["classes"]
    gt_valid = gt_classes >= 0
    rpn_draws = (draws["rpn"] if draws is not None else
                 M._uniform_pairs(b, anchors.shape[0], generator, dev))
    losses = ML.rpn_loss(logits[0].float(), deltas[0].float(), anchors,
                         gt_boxes, gt_valid, rpn_draws, loss_cfg,
                         image_hw=image_hw, anchor_inside=inside)

    with torch.no_grad():
        proposals, _, p_valid = M.rpn_proposals(
            [logits[0].detach()], [deltas[0].detach()], [anchors], image_hw,
            _single_level_cfg(cfg, train=True), canvas)
    roi_draws = (draws["roi"] if draws is not None else M._uniform_pairs(
        b, proposals.shape[1] + gt_boxes.shape[1], generator, dev))
    per_image = [ML.sample_proposals(proposals[i], p_valid[i], gt_boxes[i],
                                     gt_classes[i], gt_valid[i],
                                     *roi_draws[i], loss_cfg)
                 for i in range(b)]
    sample = {k: torch.stack([s_[k] for s_ in per_image])
              for k in per_image[0]}

    s = sample["boxes"].shape[1]
    cls_logits, box_deltas, feats = model.roi_heads.box(
        pooled_rois(cfg, c4, sample["boxes"]))
    flat = {k: v.reshape((b * s,) + v.shape[2:]) for k, v in sample.items()}
    losses.update(ML.box_head_loss(cls_logits.float(), box_deltas.float(),
                                   flat, loss_cfg))
    if cfg.mask_on:
        m = int(loss_cfg.roi_batch_per_image * loss_cfg.roi_pos_fraction)
        mfeats = feats.reshape(b, s, *feats.shape[1:])[:, :m].reshape(
            (b * m,) + feats.shape[1:])
        msample = {k: v[:, :m].reshape((b * m,) + v.shape[2:])
                   for k, v in sample.items()}
        mask_x = model.roi_heads.mask.predictor(mfeats, msample["cls_target"])
        t14 = torch.stack([ML.mask_targets_from_crops(
            sample["boxes"][i, :m], sample["gt_idx"][i, :m], gt_boxes[i],
            targets["mask_crops"][i], cfg.mask_out) for i in range(b)])
        losses.update(ML.mask_head_loss_selected(
            mask_x.float(), msample,
            t14.reshape(b * m, cfg.mask_out, cfg.mask_out), loss_cfg))
    losses["total"] = sum(losses.values())
    return losses
