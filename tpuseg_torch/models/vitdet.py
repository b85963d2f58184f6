"""ViTDet Mask R-CNN (detectron2 ``projects/ViTDet``: ``mask_rcnn_vitdet_b``
over ``common/models/mask_rcnn_vitdet.py``), inference.

The plain ViT and its simple feature pyramid (``nn/vitdet.py``) give
P2..P6; the R-CNN after them is :mod:`tpuseg_torch.models.maskrcnn`'s
(``rpn_proposals``, ``pooled_roi_features``, ``forward_heads``) with
ViTDet's heads: an RPN head of two 3x3 convs, each followed by ReLU; a
4conv1fc box head (four 3x3 convs, each conv -> channel LayerNorm ->
ReLU without bias, then fc 1024 + ReLU) and a mask head of four such
convs before the usual deconv and predictor. Inputs are RGB normalised by
ImageNet's mean and std, the short side resized to 1024 and the long side
to at most 1024, on a 1024x1024 canvas.

The R-CNN keeps the port's maskrcnn-benchmark conventions where detectron2
differs: anchor centres and +1 box extents, the background as class 0,
RoIAlign with aligned=False and sampling ratio 2 (detectron2's ViTDet uses
ROIAlignV2, aligned with adaptive sampling).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.nn.vitdet import ConvNorm, SimpleFeaturePyramid, ViT


@dataclass(frozen=True)
class ViTDetConfig(M.MaskRCNNConfig):
    """ViTDet-B's backbone and input beside the Mask R-CNN fields (whose
    defaults are mask_rcnn_fpn's test settings)."""
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    vit_depth: int = 12  # blocks (``depth`` is the ResNet's)
    num_heads: int = 12
    mlp_ratio: float = 4.0
    window_size: int = 14
    window_block_indexes: tuple = (0, 1, 3, 4, 6, 7, 9, 10)
    pretrain_img_size: int = 224
    ln_eps: float = 1e-6
    scale_factors: tuple = (4.0, 2.0, 1.0, 0.5)
    box_fc_dim: int = 1024
    pixel_mean: tuple = (123.675, 116.28, 103.53)  # RGB
    pixel_std: tuple = (58.395, 57.12, 57.375)
    min_size_test: int = 1024
    max_size_test: int = 1024


class TwoConvRPNHead(M.RPNHead):
    """detectron2's StandardRPNHead with ``conv_dims=[-1, -1]``: conv0 ->
    ReLU -> conv1 -> ReLU (the last ReLU is the base head's)."""

    def __init__(self, channels: int, num_anchors: int):
        super().__init__(channels, num_anchors)
        self.conv = nn.Sequential(OrderedDict(
            conv0=nn.Conv2d(channels, channels, 3, padding=1),
            relu0=nn.ReLU(),
            conv1=nn.Conv2d(channels, channels, 3, padding=1)))


class RPN(nn.Module):
    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.head = TwoConvRPNHead(channels, num_anchors)


class ConvFCBoxHead(nn.Module):
    """FastRCNNConvFCHead with four LN convs and one fc, then the port's
    box predictor (K class scores, K x 4 class-specific deltas)."""

    def __init__(self, channels: int, resolution: int, fc_dim: int,
                 num_classes: int, eps: float):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"conv{i}", ConvNorm(channels, channels, 3, eps))
        self.fc1 = nn.Linear(channels * resolution * resolution, fc_dim)
        self.predictor = M.BoxPredictor(fc_dim, num_classes)

    def forward(self, pooled: torch.Tensor):
        """[N, C, 7, 7] -> (class logits [N, K], box deltas [N, K*4])."""
        x = pooled
        for i in range(1, 5):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = F.relu(self.fc1(x.flatten(1)))
        return self.predictor.cls_score(x), self.predictor.bbox_pred(x)


class LNMaskFeatureExtractor(nn.Module):
    def __init__(self, channels: int, eps: float):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"mask_fcn{i}",
                            ConvNorm(channels, channels, 3, eps))


class LNMaskHead(nn.Module):
    """MaskRCNNConvUpsampleHead with ``conv_norm="LN"``: four conv -> LN ->
    ReLU, then the port's deconv and class-selected 1x1 predictor."""

    def __init__(self, channels: int, num_classes: int, eps: float):
        super().__init__()
        self.feature_extractor = LNMaskFeatureExtractor(channels, eps)
        self.predictor = M.MaskPredictor(channels, channels, num_classes)

    def forward(self, pooled: torch.Tensor, class_sel: torch.Tensor):
        """[N, C, 14, 14] -> [N, 28, 28] logits of class ``class_sel[n]``."""
        x = pooled
        for i in range(1, 5):
            x = F.relu(getattr(self.feature_extractor, f"mask_fcn{i}")(x))
        return self.predictor(x, class_sel)


class ROIHeads(nn.Module):
    def __init__(self, cfg: ViTDetConfig):
        super().__init__()
        self.box = ConvFCBoxHead(cfg.fpn_channels, cfg.pooler_resolution,
                                 cfg.box_fc_dim, cfg.num_classes, cfg.ln_eps)
        if cfg.mask_on:
            self.mask = LNMaskHead(cfg.fpn_channels, cfg.num_classes,
                                   cfg.ln_eps)


class ViTDetMaskRCNN(nn.Module):
    """``backbone`` (ViT + simple pyramid), ``rpn``, ``roi_heads``, with the
    interfaces ``maskrcnn.forward_heads`` reads; ``cfg`` rides along."""

    def __init__(self, cfg: ViTDetConfig = ViTDetConfig()):
        super().__init__()
        self.cfg = cfg
        net = ViT(cfg.img_size, cfg.patch_size, cfg.embed_dim, cfg.vit_depth,
                  cfg.num_heads, cfg.mlp_ratio, cfg.window_size,
                  cfg.window_block_indexes, cfg.pretrain_img_size, cfg.ln_eps)
        self.backbone = SimpleFeaturePyramid(net, cfg.fpn_channels,
                                             cfg.scale_factors, cfg.ln_eps)
        self.rpn = RPN(cfg.fpn_channels, len(cfg.anchor_ratios))
        self.roi_heads = ROIHeads(cfg)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``: conv and linear weights
    N(0, 1/fan_in), biases 0, LayerNorms the identity, the position table
    N(0, 0.02^2), the relative-position tables 0 (upstream's zero init)."""
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.endswith("pos_embed"):
                t.normal_(0.0, 0.02, generator=generator)
            elif "rel_pos" in name or name.endswith("bias"):
                t.zero_()
            elif t.ndim == 1:  # LayerNorm scales
                t.fill_(1.0)
            else:
                t.normal_(0.0, t[0].numel() ** -0.5, generator=generator)
    return model


def build_model(cfg: ViTDetConfig = ViTDetConfig(),
                generator: torch.Generator | None = None) -> ViTDetMaskRCNN:
    """A CPU model: random weights from ``generator`` if one is given,
    otherwise uninitialised storage for ``load_state_dict`` to fill."""
    with torch.device("meta"):
        model = ViTDetMaskRCNN(cfg)
    model = model.to_empty(device="cpu")
    if generator is not None:
        init_weights(model, generator)
    return model.eval()


# the R-CNN after the backbone is Mask R-CNN FPN's
forward_inference = M.forward_inference
