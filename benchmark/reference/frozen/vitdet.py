"""The plain reference of ViTDet's backbone and heads, written from the
published description (Li, Mao, Girshick, He, arXiv:2203.16527) and
detectron2's ``modeling/backbone/vit.py``, ``backbone/utils.py``
(``window_partition``, ``window_unpartition``, ``get_rel_pos``,
``add_decomposed_rel_pos``, ``get_abs_pos``), ``SimpleFeaturePyramid``,
``layers/batch_norm.py::LayerNorm``, ``StandardRPNHead`` and
``FastRCNNConvFCHead`` / ``MaskRCNNConvUpsampleHead`` with
``conv_norm="LN"``, in plain torch (float32 with TF32 off under
``reference/exact.py``). It imports nothing of the port; its module paths
are the program's state_dict keys, so one state dict loads into both.

Departures from detectron2, shared with the program's R-CNN: the box
predictor keeps a background class 0 with K x 4 class-specific deltas
(``frozen/maskrcnn.py::BoxPredictor``) and the mask predictor selects the
detected class's 1x1 row (``MaskPredictor``); the rest of Mask R-CNN is
``frozen/maskrcnn_infer.py``. The relative-position tables are used at the
size they were made for (detectron2 interpolates a table made for another
size; the configuration never asks for that).
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from .maskrcnn import BoxPredictor, MaskPredictor


class LayerNorm2d(nn.Module):
    """detectron2's ``LayerNorm``: over the channels of [N, C, H, W]."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class Conv2dNorm(nn.Conv2d):
    """detectron2's ``Conv2d`` with a ``norm``, no bias, no activation."""

    def __init__(self, cin, cout, k, eps=1e-6):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = LayerNorm2d(cout, eps)

    def forward(self, x):
        return self.norm(F.conv2d(x, self.weight, None, 1, self.padding))


def window_partition(x, window_size):
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size,
               window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(
        -1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size,
                     window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :].contiguous()
    return x


def get_rel_pos(q_size, k_size, rel_pos):
    """The table's rows for each (query, key) pair: [q_size, k_size, C]."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        raise ValueError("a relative-position table made for another size")
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = ((q_coords - k_coords)
                       + (k_size - 1) * max(q_size / k_size, 1.0))
    return rel_pos[relative_coords.long().to(rel_pos.device)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(B, q_h * q_w, k_h * k_w)
    return attn


class Attention(nn.Module):
    def __init__(self, dim, num_heads, input_size):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  head_dim))

    def forward(self, x):
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, -1).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.num_heads, H * W, -1).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h,
                                      self.rel_pos_w, (H, W), (H, W))
        attn = attn.softmax(dim=-1)
        x = (attn @ v).view(B, self.num_heads, H, W, -1).permute(
            0, 2, 3, 1, 4).reshape(B, H, W, -1)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, window_size, input_size,
                 eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, input_size if window_size == 0
                              else (window_size, window_size))
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        x = x + self.mlp(self.norm2(x))
        return x


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, embed_dim):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, kernel_size=patch_size,
                              stride=patch_size)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


def get_abs_pos(abs_pos, has_cls_token, hw):
    h, w = hw
    if has_cls_token:
        abs_pos = abs_pos[:, 1:]
    xy_num = abs_pos.shape[1]
    size = int(math.sqrt(xy_num))
    if size != h or size != w:
        new_abs_pos = F.interpolate(
            abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2),
            size=(h, w), mode="bicubic", align_corners=False)
        return new_abs_pos.permute(0, 2, 3, 1)
    return abs_pos.reshape(1, h, w, -1)


class ViT(nn.Module):
    def __init__(self, img_size, patch_size, embed_dim, depth, num_heads,
                 mlp_ratio, window_size, window_block_indexes,
                 pretrain_img_size, eps):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        num_patches = (pretrain_img_size // patch_size) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1,
                                                  embed_dim))
        self.blocks = nn.ModuleList()
        for i in range(depth):
            self.blocks.append(Block(
                embed_dim, num_heads, mlp_ratio,
                window_size if i in window_block_indexes else 0,
                (img_size // patch_size, img_size // patch_size), eps))

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + get_abs_pos(self.pos_embed, True, (x.shape[1], x.shape[2]))
        for blk in self.blocks:
            x = blk(x)
        return x.permute(0, 3, 1, 2)


class SimpleFeaturePyramid(nn.Module):
    def __init__(self, net, dim, out_channels, scale_factors, eps):
        super().__init__()
        self.net = net
        self.stage_names = []
        for scale in scale_factors:
            out_dim = dim
            if scale == 4.0:
                layers = [nn.ConvTranspose2d(dim, dim // 2, kernel_size=2,
                                             stride=2),
                          LayerNorm2d(dim // 2, eps), nn.GELU(),
                          nn.ConvTranspose2d(dim // 2, dim // 4,
                                             kernel_size=2, stride=2)]
                out_dim = dim // 4
            elif scale == 2.0:
                layers = [nn.ConvTranspose2d(dim, dim // 2, kernel_size=2,
                                             stride=2)]
                out_dim = dim // 2
            elif scale == 1.0:
                layers = []
            elif scale == 0.5:
                layers = [nn.MaxPool2d(kernel_size=2, stride=2)]
            else:
                raise NotImplementedError(f"scale_factor={scale}")
            layers.extend([Conv2dNorm(out_dim, out_channels, 1, eps),
                           Conv2dNorm(out_channels, out_channels, 3, eps)])
            name = f"simfp_{int(math.log2(16 / scale))}"
            self.add_module(name, nn.Sequential(*layers))
            self.stage_names.append(name)

    def forward(self, x):
        features = self.net(x)
        results = [getattr(self, n)(features) for n in self.stage_names]
        # LastLevelMaxPool on the last output
        results.append(F.max_pool2d(results[-1], kernel_size=1, stride=2,
                                    padding=0))
        return results


class StandardRPNHead(nn.Module):
    """``conv_dims=[-1, -1]``: two 3x3 convs, each followed by ReLU."""

    def __init__(self, channels, num_anchors):
        super().__init__()
        self.conv = nn.Sequential(OrderedDict(
            conv0=nn.Conv2d(channels, channels, 3, padding=1),
            relu0=nn.ReLU(),
            conv1=nn.Conv2d(channels, channels, 3, padding=1),
            relu1=nn.ReLU()))
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, features):
        """-> per level: logits [B, H*W*A] and deltas [B, H*W*A, 4] in
        (H, W, A) order."""
        logits, deltas = [], []
        for f in features:
            t = self.conv(f)
            b = t.shape[0]
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1)
                          .reshape(b, -1))
            deltas.append(self.bbox_pred(t).permute(0, 2, 3, 1)
                          .reshape(b, -1, 4))
        return logits, deltas


class RPN(nn.Module):
    def __init__(self, channels, num_anchors):
        super().__init__()
        self.head = StandardRPNHead(channels, num_anchors)


class FastRCNNConvFCHead(nn.Module):
    def __init__(self, channels, resolution, fc_dim, num_classes, eps):
        super().__init__()
        for k in range(1, 5):
            self.add_module(f"conv{k}", Conv2dNorm(channels, channels, 3, eps))
        self.fc1 = nn.Linear(channels * resolution * resolution, fc_dim)
        self.predictor = BoxPredictor(fc_dim, num_classes)

    def forward(self, x):
        for k in range(1, 5):
            x = F.relu(getattr(self, f"conv{k}")(x))
        x = F.relu(self.fc1(torch.flatten(x, start_dim=1)))
        return self.predictor.cls_score(x), self.predictor.bbox_pred(x)


class MaskFeatureExtractor(nn.Module):
    def __init__(self, channels, eps):
        super().__init__()
        for k in range(1, 5):
            self.add_module(f"mask_fcn{k}",
                            Conv2dNorm(channels, channels, 3, eps))


class MaskRCNNConvUpsampleHead(nn.Module):
    def __init__(self, channels, num_classes, eps):
        super().__init__()
        self.feature_extractor = MaskFeatureExtractor(channels, eps)
        self.predictor = MaskPredictor(channels, channels, num_classes)

    def forward(self, x, class_sel):
        for k in range(1, 5):
            x = F.relu(getattr(self.feature_extractor, f"mask_fcn{k}")(x))
        return self.predictor(x, class_sel)


class ROIHeads(nn.Module):
    def __init__(self, cfg, vit: dict):
        super().__init__()
        self.box = FastRCNNConvFCHead(cfg.fpn_channels, cfg.pooler_resolution,
                                      vit["box_fc_dim"], cfg.num_classes,
                                      vit["ln_eps"])
        self.mask = MaskRCNNConvUpsampleHead(cfg.fpn_channels,
                                             cfg.num_classes, vit["ln_eps"])


class ViTDetMaskRCNN(nn.Module):
    """``backbone``, ``rpn``, ``roi_heads``: the R-CNN's fields in ``cfg``
    (``frozen/maskrcnn.py::MaskRCNNConfig``, which ``maskrcnn_infer.py``
    reads), the backbone's in ``vit`` (``reference/maskrcnn_vitdet_b.py``
    makes both from the configuration file)."""

    def __init__(self, cfg, vit: dict):
        super().__init__()
        self.cfg = cfg
        net = ViT(vit["img_size"], vit["patch_size"], vit["embed_dim"],
                  vit["depth"], vit["num_heads"], vit["mlp_ratio"],
                  vit["window_size"], vit["window_block_indexes"],
                  vit["pretrain_img_size"], vit["ln_eps"])
        self.backbone = SimpleFeaturePyramid(
            net, vit["embed_dim"], cfg.fpn_channels, vit["scale_factors"],
            vit["ln_eps"])
        self.rpn = RPN(cfg.fpn_channels, len(cfg.anchor_ratios))
        self.roi_heads = ROIHeads(cfg, vit)


def build_model(cfg, vit: dict) -> ViTDetMaskRCNN:
    """A CPU model, its storage uninitialised for ``load_state_dict``."""
    with torch.device("meta"):
        model = ViTDetMaskRCNN(cfg, vit)
    return model.to_empty(device="cpu").eval()
