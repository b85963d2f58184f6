"""YOLACT and YOLACT++ (port of ``tpuseg/models/yolact.py``): inference,
and the training forward the loss of ``models/yolact_loss.py`` reads.

ResNet backbone (DCNv2 in stages 2-4 for ++) or DarkNet-53 -> YOLACT FPN
(P3..P7 from the C3-C5 taps) -> one
shared PredictionModule (box deltas, class logits, tanh mask coefficients
over all levels) + ProtoNet at P3 (k ReLU prototypes at twice P3's size)
-> :func:`detect`: SSD decode, softmax, the prior gate, Fast-NMS per class
(or greedy NMS), the global top ``max_num_detections``, masks as
``sigmoid(proto @ coeff)`` cropped to their boxes, and for ++ the
FastMaskIoUNet rescoring.

The padded contract of the JAX package is kept: [B, max_num_detections]
outputs plus ``valid``. Module attribute paths are dbolya/yolact's
state_dict keys (``backbone.layers.{s}.{b}...``, ``fpn.lat_layers``,
``proto_net.{0,2,4,8,10}``, ``prediction_layers.0.*``,
``semantic_seg_conv``, ``maskiou_net.maskiou_net.*``), so an upstream
checkpoint loads with ``strict=True``; DarkNet-53 keeps
``nn/darknet.py``'s names, onto which ``weights/yolact_map.py`` maps
upstream's. Tensors are NCHW; the prototypes
are [B, S, S, k], as upstream and the JAX package keep them.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.core import boxes as box_ops
from tpuseg_torch.nn.darknet import STAGES as DARKNET_STAGES
from tpuseg_torch.nn.darknet import DarkNet53
from tpuseg_torch.nn.fpn import YolactFPN
from tpuseg_torch.nn.resnet import ResNetBackbone
from tpuseg_torch.ops import nms as nms_ops


@dataclass(frozen=True)
class YolactConfig:
    """The JAX ``YolactConfig``'s fields (same defaults), less the TPU-only
    ``approx_topk``."""
    backbone: str = "resnet50"  # resnet50 | resnet101 | darknet53
    img_size: int = 550
    num_classes: int = 81  # incl background
    mask_dim: int = 32
    fpn_channels: int = 256
    aspect_ratios: tuple = (1.0, 0.5, 2.0)
    # per-level anchor scales: one per level (yolact) or a tuple per level
    # (yolact++: 3 sub-scales s * 2^(j/3))
    scales: tuple = (24, 48, 96, 192, 384)
    use_square_anchors: bool = True
    conf_thresh: float = 0.05
    nms_iou_thresh: float = 0.5
    nms_top_k: int = 200
    max_num_detections: int = 100
    variances: tuple = (0.1, 0.2)
    # Fast-NMS (default) or upstream's traditional per-class greedy NMS
    use_fast_nms: bool = True
    # two-stage candidate selection: the top `prior_topk` priors by max
    # class score first (in logit space), then per-class top-k over them;
    # exact whenever at most prior_topk priors pass conf_thresh; 0 = off
    prior_topk: int = 0
    # YOLACT++ extras
    dcn_backbone: bool = False  # DCNv2 in stages 2-4
    use_maskiou: bool = False  # FastMaskIoUNet mask rescoring

    def level_scales(self, li: int) -> tuple:
        s = self.scales[li]
        return tuple(s) if isinstance(s, (tuple, list)) else (s,)

    @property
    def num_anchors(self) -> int:
        return len(self.aspect_ratios) * len(self.level_scales(0))

    @property
    def depth(self) -> int:
        """The ResNet's depth, or DarkNet's 53."""
        return int(self.backbone.removeprefix("resnet")
                   .removeprefix("darknet"))


def level_sizes(cfg: YolactConfig) -> tuple:
    """P3..P7 sizes: a ceil halving per stride-2 conv (550 -> 69, 35, 18,
    9, 5)."""
    x = cfg.img_size
    sizes = []
    for i in range(7):
        x = (x + 1) // 2
        if i >= 2:
            sizes.append(x)
    return tuple(sizes)


@functools.lru_cache(maxsize=8)
def make_priors_np(cfg: YolactConfig) -> np.ndarray:
    """Priors [N, 4] (cx, cy, w, h), normalised (the port's copy of the JAX
    ``make_priors_np``): per level, per cell in row-major order, scale-major
    then aspect ratio; w = scale * sqrt(ar) / img_size, h = w for square
    anchors (yolact_base) else scale / sqrt(ar) / img_size (++)."""
    priors = []
    for li, size in enumerate(level_sizes(cfg)):
        for j in range(size):
            for i in range(size):
                cx = (i + 0.5) / size
                cy = (j + 0.5) / size
                for scale in cfg.level_scales(li):
                    for ar in cfg.aspect_ratios:
                        ar_s = math.sqrt(ar)
                        w = scale * ar_s / cfg.img_size
                        h = w if cfg.use_square_anchors else (
                            scale / ar_s / cfg.img_size)
                        priors.append([cx, cy, w, h])
    return np.asarray(priors, np.float32)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class ProtoNet(nn.Sequential):
    """``proto_net``: 3 x (conv3x3 + ReLU), bilinear x2, conv3x3 + ReLU,
    conv1x1 to ``mask_dim`` (upstream's Sequential indices 0, 2, 4, 8, 10),
    then the prototypes' ReLU."""

    def __init__(self, in_channels: int, mask_dim: int):
        c = 256
        super().__init__(
            nn.Conv2d(in_channels, c, 3, padding=1), nn.ReLU(),
            nn.Conv2d(c, c, 3, padding=1), nn.ReLU(),
            nn.Conv2d(c, c, 3, padding=1), nn.ReLU(),
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False),
            nn.ReLU(),
            nn.Conv2d(c, c, 3, padding=1), nn.ReLU(),
            nn.Conv2d(c, mask_dim, 1))

    def forward(self, p3: torch.Tensor) -> torch.Tensor:
        """P3 [B, C, h, w] -> prototypes [B, 2h, 2w, mask_dim]."""
        return F.relu(super().forward(p3)).permute(0, 2, 3, 1)


class PredictionModule(nn.Module):
    """The head shared by all levels (``prediction_layers.0``)."""

    def __init__(self, cfg: YolactConfig):
        super().__init__()
        fc, na = cfg.fpn_channels, cfg.num_anchors
        self.num_classes, self.mask_dim = cfg.num_classes, cfg.mask_dim
        self.upfeature = nn.Sequential(nn.Conv2d(fc, 256, 3, padding=1),
                                       nn.ReLU())
        self.bbox_layer = nn.Conv2d(256, na * 4, 3, padding=1)
        self.conf_layer = nn.Conv2d(256, na * cfg.num_classes, 3, padding=1)
        self.mask_layer = nn.Conv2d(256, na * cfg.mask_dim, 3, padding=1)

    def forward(self, p: torch.Tensor) -> tuple:
        """One level -> loc [B, hw*na, 4], conf [B, hw*na, C], coeff
        [B, hw*na, k]: the channels of a cell are its anchors' values."""
        x = self.upfeature(p)

        def flat(t, d):
            return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, d)

        return (flat(self.bbox_layer(x), 4),
                flat(self.conf_layer(x), self.num_classes),
                torch.tanh(flat(self.mask_layer(x), self.mask_dim)))


class FastMaskIoUNet(nn.Module):
    """YOLACT++ mask rescoring (``maskiou_net``): five stride-2 conv3x3 +
    ReLU (8..128 channels), a 1x1 conv to the classes + ReLU, then a max
    over space. The 1x1 conv runs before the max: a max and a signed linear
    map do not commute."""

    def __init__(self, num_classes: int):
        super().__init__()
        layers, cin = [], 1
        for ch in (8, 16, 32, 64, 128):
            layers += [nn.Conv2d(cin, ch, 3, stride=2, padding=1), nn.ReLU()]
            cin = ch
        layers += [nn.Conv2d(cin, num_classes - 1, 1), nn.ReLU()]
        self.maskiou_net = nn.Sequential(*layers)

    def forward(self, masks: torch.Tensor) -> torch.Tensor:
        """[N, S, S] masks -> [N, C-1]. The weights are cast to the masks'
        dtype (f32 masks of a bf16 model compute in f32, as in the JAX
        package)."""
        x = masks[:, None]
        for layer in self.maskiou_net:
            if isinstance(layer, nn.Conv2d):
                x = F.conv2d(x, layer.weight.to(x.dtype),
                             layer.bias.to(x.dtype), layer.stride,
                             layer.padding)
            else:
                x = layer(x)
        return x.amax(dim=(2, 3))


class Yolact(nn.Module):
    def __init__(self, cfg: YolactConfig = YolactConfig()):
        super().__init__()
        self.cfg = cfg
        depth = cfg.depth
        if cfg.backbone.startswith("resnet"):
            self.backbone = ResNetBackbone(
                depth, dcn_stages=(1, 2, 3) if cfg.dcn_backbone else (),
                dcn_interval=3 if depth == 101 else 1)
            taps = self.backbone.out_channels[1:]
        else:
            self.backbone = DarkNet53()
            taps = tuple(ch for ch, _ in DARKNET_STAGES[2:])
        fc = cfg.fpn_channels
        self.fpn = YolactFPN(taps, fc)
        self.proto_net = ProtoNet(fc, cfg.mask_dim)
        self.prediction_layers = nn.ModuleList([PredictionModule(cfg)])
        # the semantic logits of the training loss, never run at inference
        self.semantic_seg_conv = nn.Conv2d(fc, cfg.num_classes - 1, 1)
        self.maskiou_net = (FastMaskIoUNet(cfg.num_classes)
                            if cfg.use_maskiou else None)
        # BatchNorms in eval mode under train() (see train)
        self.freeze_bn = False

    def taps(self, images: torch.Tensor) -> list:
        """The backbone's C3, C4, C5 (strides 8, 16, 32)."""
        feats = self.backbone(images)
        if isinstance(feats, dict):  # DarkNet-53
            return [feats[k] for k in ("c3", "c4", "c5")]
        return feats[1:]

    def forward(self, images: torch.Tensor) -> dict:
        """images [B, 3, S, S] normalised -> proto [B, Sp, Sp, k], loc
        [B, N, 4], conf [B, N, C], coeff [B, N, k]."""
        return self._heads(self.fpn(self.taps(images)))

    def forward_train(self, images: torch.Tensor) -> tuple:
        """The training forward (``tpuseg/models/yolact.py::forward_train``):
        :meth:`forward`'s predictions and the semantic logits of P3
        [B, Hs, Ws, C-1]."""
        pyramid = self.fpn(self.taps(images))
        sem = self.semantic_seg_conv(pyramid[0]).permute(0, 2, 3, 1)
        return self._heads(pyramid), sem

    def _heads(self, pyramid) -> dict:
        head = self.prediction_layers[0]
        locs, confs, coeffs = zip(*(head(p) for p in pyramid))
        return {"proto": self.proto_net(pyramid[0]), "loc": torch.cat(locs, 1),
                "conf": torch.cat(confs, 1), "coeff": torch.cat(coeffs, 1)}

    def train(self, mode: bool = True):
        """With ``freeze_bn`` set, the BatchNorms (ResNet's and DarkNet's)
        stay in eval mode in training (running statistics, none updated)
        while their affine parameters still train, as the JAX trainer's
        ``freeze_bn`` (upstream also stops their gradient; see ROADMAP)."""
        super().train(mode)
        if mode and self.freeze_bn:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self


def build_model(cfg: YolactConfig = YolactConfig(),
                generator: torch.Generator | None = None) -> Yolact:
    """A CPU model in eval mode: random weights from ``generator`` if one
    is given (conv weights N(0, 1/fan_in), biases 0, BN the identity, DCN
    offsets 0 as upstream initialises them), otherwise uninitialised storage
    for ``load_state_dict`` to fill."""
    with torch.device("meta"):
        model = Yolact(cfg)
    model = model.to_empty(device="cpu")
    if generator is not None:
        with torch.no_grad():
            for name, t in model.state_dict().items():
                if "conv_offset_mask" in name or name.endswith(
                        ("bias", "running_mean", "num_batches_tracked")):
                    t.zero_()
                elif t.ndim == 4:
                    t.normal_(0.0, t[0].numel() ** -0.5, generator=generator)
                else:  # BN weight and running_var
                    t.fill_(1.0)
    return model.eval()


# ---------------------------------------------------------------------------
# Detect (layers/functions/detection.py) and mask assembly (output_utils.py)
# ---------------------------------------------------------------------------


def crop_masks(masks: torch.Tensor, boxes: torch.Tensor,
               padding: int = 1) -> torch.Tensor:
    """Zero mask pixels outside each box (yolact ``box_utils.crop``):
    masks [B, S, S, K], boxes [B, K, 4] normalised xyxy. The box is scaled
    to the mask grid, padded by ``padding`` on each side and clamped
    (``sanitize_coordinates(cast=False)``); the right and bottom edges are
    exclusive."""
    s = masks.shape[1]
    x1, y1, x2, y2 = (boxes[..., i] * s for i in range(4))  # [B, K]
    x1, x2 = torch.minimum(x1, x2), torch.maximum(x1, x2)
    y1, y2 = torch.minimum(y1, y2), torch.maximum(y1, y2)
    x1, y1 = (x1 - padding).clamp(min=0), (y1 - padding).clamp(min=0)
    x2, y2 = (x2 + padding).clamp(max=s), (y2 + padding).clamp(max=s)
    grid = torch.arange(s, dtype=masks.dtype, device=masks.device)
    rows, cols = grid[None, :, None, None], grid[None, None, :, None]
    inside = ((rows >= y1[:, None, None]) & (rows < y2[:, None, None])
              & (cols >= x1[:, None, None]) & (cols < x2[:, None, None]))
    return torch.where(inside, masks, 0.0)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] rows by idx [B, ...] -> [B, ..., ...rest]."""
    flat = box_ops.gather_along_n(x, idx.reshape(idx.shape[0], -1))
    return flat.reshape(idx.shape + x.shape[2:])


def detect(preds: dict, priors: torch.Tensor, cfg: YolactConfig,
           maskiou_net: FastMaskIoUNet | None = None) -> dict:
    """Raw predictions (f32) -> padded detections, batched over images.

    The prior gate: a prior survives when its largest class score exceeds
    ``conf_thresh`` and then keeps all its class scores (Detect.__call__).
    With ``prior_topk``, the gate runs in logit space (max_fg l -
    logsumexp(l) > log(conf_thresh), log taken in f32 as the JAX package
    does) over the top ``prior_topk`` priors. Then Fast-NMS (or greedy NMS,
    one K1 launch for the batch) per class at ``nms_top_k``, the global top
    ``max_num_detections``, masks sigmoid(proto @ coeff) cropped to their
    boxes. Returns boxes [B, K, 4] (normalised xyxy), scores, classes
    (0-based, no background), masks [B, K, Sp, Sp], valid; with a
    ``maskiou_net``, ``mask_scores`` = score x the mask's predicted IoU for
    its class.
    """
    loc, conf, coeff, proto = (preds[k] for k in ("loc", "conf", "coeff",
                                                  "proto"))
    b, n, _ = conf.shape
    if cfg.prior_topk and cfg.prior_topk < n:
        log_max_s = conf[..., 1:].amax(-1) - torch.logsumexp(conf, -1)
        prior_ok = log_max_s > float(np.log(np.float32(cfg.conf_thresh)))
        _, pidx, pv = box_ops.masked_topk(log_max_s, prior_ok, cfg.prior_topk)
        scores = F.softmax(_gather(conf, pidx), -1)[..., 1:].transpose(1, 2)
        scores = torch.where(pv[:, None, :], scores, 0.0)  # [B, C-1, K]
        boxes = box_ops.ssd_decode(_gather(loc, pidx), priors[pidx],
                                   cfg.variances)
        prior_map = pidx  # compacted slot -> prior
    else:
        boxes = box_ops.ssd_decode(loc, priors, cfg.variances)  # [B, N, 4]
        scores = F.softmax(conf, -1)[..., 1:].transpose(1, 2)  # [B, C-1, N]
        prior_ok = scores.amax(1) > cfg.conf_thresh
        scores = torch.where(prior_ok[:, None, :], scores, 0.0)
        prior_map = None
    if cfg.use_fast_nms:
        cboxes, cscores, cclasses, cidx, keep = nms_ops.fast_nms(
            boxes, scores, cfg.nms_iou_thresh, cfg.nms_top_k)
    else:  # traditional NMS: exact greedy per class over its top nms_top_k
        c = scores.shape[1]
        cscores, cidx, top_v = box_ops.masked_topk(
            scores, scores > cfg.conf_thresh, cfg.nms_top_k)  # [B, C, K]
        cboxes = _gather(boxes, cidx)
        cclasses = torch.arange(c, device=scores.device)[None, :, None
                                                         ].expand_as(cidx)
        keep = nms_ops.batched_nms_mask(
            cboxes.reshape(b, -1, 4), cscores.reshape(b, -1),
            cclasses.reshape(b, -1), cfg.nms_iou_thresh,
            valid=top_v.reshape(b, -1)).reshape(cidx.shape)
    flat_scores = torch.where(keep, cscores, 0.0).reshape(b, -1)
    top_s, sel, valid = box_ops.masked_topk(flat_scores, flat_scores > 0.0,
                                            cfg.max_num_detections)
    out_boxes = _gather(cboxes.reshape(b, -1, 4), sel)
    out_classes = torch.gather(cclasses.reshape(b, -1), 1, sel)
    sel_pidx = torch.gather(cidx.reshape(b, -1), 1, sel)
    if prior_map is not None:
        sel_pidx = torch.gather(prior_map, 1, sel_pidx)
    out_coeff = _gather(coeff, sel_pidx)  # [B, K, k]
    m = torch.sigmoid(torch.einsum("bhwk,bnk->bhwn", proto, out_coeff))
    masks = crop_masks(m, out_boxes).permute(0, 3, 1, 2)
    out = {"boxes": out_boxes, "scores": torch.where(valid, top_s, 0.0),
           "classes": out_classes, "masks": masks, "valid": valid}
    if maskiou_net is not None:
        k, s = masks.shape[1], masks.shape[2]
        iou = maskiou_net(masks.reshape(b * k, s, s)).reshape(b, k, -1)
        cls_iou = torch.gather(iou, 2, out_classes[..., None])[..., 0]
        out["mask_scores"] = out["scores"] * cls_iou
    return out
