"""Pose2Seg, pose-conditioned human instance segmentation (the port's copy
of ``tpuseg/models/pose2seg.py``; Pose2Seg.jittor, arXiv:1803.10683).

Image + per-person COCO keypoints -> per-person masks:
  ResNet-50 with a dilated C5 + the pose FPN -> P2 (stride 4) -> per
  person: the keypoints matched against the pose templates -> the best
  similarity transform -> AffineAlign crop (64x64, the DCN sampling kernel)
  -> concat skeleton features (17 Gaussian heatmaps + 19 COCO-limb PAFs =
  55 channels) -> the resnet10units SegModule -> 2-class logits -> the
  foreground pasted back over the canvas under the inverse affine.

The host half (templates, the affine solve, OKS scoring, skeleton
rasterisation) is a numpy copy of the JAX package's, equal to it. Module
names are upstream's, so a released ``last.pkl`` maps onto them: the
ResNet (torchvision names) and the FPN convs ``toplayer``,
``latlayer1-3``, ``smooth1-3`` side by side under ``backbone.``, the
SegModule under ``segnet.`` (``conv1``, ``bn1``, ``layers.{i}``, the 1x1
classifier ``conv2``). Images and features are NCHW; the aligned crops
and the logits keep the JAX package's channels-last layout ([B, P, O, O,
C]), which the SegModule reads as channels-last NCHW without a copy.
"""
from __future__ import annotations

import functools
import json
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.nn.resnet import BottleneckTV, ResNetTV
from tpuseg_torch.ops.sampling import affine_align, affine_grid


@dataclass(frozen=True)
class Pose2SegConfig:
    input_size: int = 512
    align_size: int = 64
    max_people: int = 16
    num_keypoints: int = 17
    seg_units: int = 10  # resnet10units
    feature_channels: int = 256
    mask_thresh: float = 0.5
    # skeleton features concatenated to the aligned crop (segnet input
    # 256 + 55)
    cat_skeleton: bool = True
    dilation_c5: int = 2  # C5 at stride 16
    # the paste grid: the aligned mask carries 64x64 of content, so it is
    # pasted at 256 and resized to the image
    paste_size: int = 256
    # an upstream templates.json; the regenerated templates when None
    template_file: str | None = None

    @property
    def skeleton_channels(self) -> int:
        # 17 keypoint Gaussians + 19 COCO-skeleton limbs x (x, y) PAF = 55
        return self.num_keypoints + 2 * len(COCO_SKELETON)


# ---------------------------------------------------------------------------
# COCO skeleton + OKS constants
# ---------------------------------------------------------------------------

# the COCO person skeleton (0-indexed pairs; 19 limbs)
COCO_SKELETON = (
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
)

# COCOeval's per-keypoint OKS sigmas
COCO_KPT_SIGMAS = np.asarray(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89], np.float64) / 10.0


# ---------------------------------------------------------------------------
# Pose templates, in a unit frame [0, 1]^2, COCO keypoint order. The
# built-ins are the JAX package's regenerated canonical poses (standing,
# upper body, mirror); ``Pose2SegConfig.template_file`` reads upstream's.
# ---------------------------------------------------------------------------

_STAND = np.array([
    [0.50, 0.08], [0.53, 0.06], [0.47, 0.06], [0.57, 0.08], [0.43, 0.08],
    [0.62, 0.20], [0.38, 0.20], [0.66, 0.35], [0.34, 0.35], [0.68, 0.50],
    [0.32, 0.50], [0.58, 0.52], [0.42, 0.52], [0.57, 0.72], [0.43, 0.72],
    [0.57, 0.92], [0.43, 0.92],
], np.float64)

_UPPER = np.array([
    [0.50, 0.15], [0.55, 0.11], [0.45, 0.11], [0.62, 0.15], [0.38, 0.15],
    [0.72, 0.38], [0.28, 0.38], [0.80, 0.65], [0.20, 0.65], [0.84, 0.88],
    [0.16, 0.88], [0.60, 0.90], [0.40, 0.90], [0.60, 0.99], [0.40, 0.99],
    [0.60, 0.99], [0.40, 0.99],
], np.float64)


def load_templates_json(path: str) -> np.ndarray:
    """A templates.json -> [T, 17, 2] unit-frame poses: a bare list of
    poses, or a dict holding them under 'templates' / 'TEMPLATES' /
    'template' (else its values); each pose [17][2] or [17][3] (the
    visibility dropped); pixel-space templates (any coordinate > 2) are
    normalised by one shared span per template, keeping the aspect."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        for k in ("templates", "TEMPLATES", "template"):
            if k in data:
                data = data[k]
                break
        else:  # dict of named poses
            data = list(data.values())
    arr = np.asarray(data, np.float64)
    if arr.ndim == 2:
        arr = arr[None]
    arr = arr[:, :, :2]
    hi = arr.reshape(-1, 2).max(0)
    if (hi > 2.0).any():
        lo = arr.min(axis=1, keepdims=True)
        span = np.maximum((arr.max(axis=1, keepdims=True) - lo)
                          .max(axis=2, keepdims=True), 1e-6)
        arr = (arr - lo) / span
    return arr


@functools.lru_cache(maxsize=4)
def _templates_cached(template_file: str) -> np.ndarray:
    return load_templates_json(template_file)


def templates(cfg: Pose2SegConfig | None = None) -> np.ndarray:
    """[T, 17, 2] canonical poses in the unit alignment frame."""
    if cfg is not None and cfg.template_file:
        return _templates_cached(cfg.template_file)
    flip = _STAND.copy()
    flip[:, 0] = 1.0 - flip[:, 0]
    return np.stack([_STAND, _UPPER, flip])


# ---------------------------------------------------------------------------
# Affine solve + template scoring (upstream PoseAlign)
# ---------------------------------------------------------------------------


def solve_similarity(src: np.ndarray, dst: np.ndarray, valid: np.ndarray):
    """Least-squares similarity transform (scale, rotation, translation)
    src -> dst over the valid keypoints (closed-form Umeyama) -> (2x3
    matrix, mean residual); (None, inf) with fewer than two points or no
    spread."""
    s = src[valid]
    d = dst[valid]
    n = len(s)
    if n < 2:
        return None, np.inf
    mu_s = s.mean(0)
    mu_d = d.mean(0)
    sc = s - mu_s
    dc = d - mu_d
    cov = dc.T @ sc / n
    var_s = (sc**2).sum() / n
    if var_s < 1e-12:
        return None, np.inf
    U, S, Vt = np.linalg.svd(cov)
    sgn = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, sgn])
    R = U @ D @ Vt
    scale = np.trace(np.diag(S) @ D) / var_s
    t = mu_d - scale * R @ mu_s
    A = np.concatenate([scale * R, t[:, None]], axis=1)  # [2, 3]
    res = np.sqrt(((scale * (R @ sc.T).T - dc) ** 2).sum(1)).mean()
    return A, res


def template_oks(kpts: np.ndarray, tpl: np.ndarray, A: np.ndarray,
                 valid: np.ndarray) -> float:
    """OKS-style agreement of the person's visible keypoints, warped into
    the unit frame by A, with a template: mean exp(-d^2 / (2 s^2 k_i^2)),
    s^2 the template's extent."""
    if not valid.any():
        return 0.0
    pts = kpts[valid, :2] @ A[:, :2].T + A[:, 2]
    d2 = ((pts - tpl[valid]) ** 2).sum(1)
    span = tpl[valid].max(0) - tpl[valid].min(0)
    s2 = max(float(span[0] * span[1]), 1e-3)
    k2 = (2 * COCO_KPT_SIGMAS[valid]) ** 2
    return float(np.mean(np.exp(-d2 / (2.0 * s2 * k2))))


def choose_template(kpts: np.ndarray, cfg: Pose2SegConfig):
    """kpts [17, 3] (x, y, visibility) in canvas pixels -> (A [2, 3]
    canvas px -> unit frame, score, template index); (None, -1.0, -1)
    when no template can be solved."""
    valid = kpts[:, 2] > 0
    best = (None, -1.0, -1)
    for ti, tpl in enumerate(templates(cfg)):
        A, res = solve_similarity(kpts[:, :2].astype(np.float64), tpl, valid)
        if A is None:
            continue
        score = template_oks(kpts, tpl, A, valid)
        if score > best[1]:
            best = (A, score, ti)
    return best


def affine_to_theta(A: np.ndarray, h: int, w: int) -> np.ndarray:
    """The pixel-space 'image -> unit frame' affine -> the normalised theta
    of :func:`~tpuseg_torch.ops.sampling.affine_align` (output grid ->
    input, torch's ``align_corners=False`` conventions on both sides)."""
    A3 = np.concatenate([A, [[0, 0, 1.0]]], 0)
    inv = np.linalg.inv(A3)  # align frame -> image px
    M_u = np.array([[0.5, 0, 0.5], [0, 0.5, 0.5], [0, 0, 1]])
    M_n = np.array([[2.0 / w, 0, 1.0 / w - 1], [0, 2.0 / h, 1.0 / h - 1],
                    [0, 0, 1]])
    full = M_n @ inv @ M_u
    return full[:2].astype(np.float32)


def inverse_theta(A: np.ndarray, h: int, w: int) -> np.ndarray:
    """The theta that pastes an aligned mask back onto the (h, w) canvas:
    output grid over the image, sampling from the aligned frame."""
    A3 = np.concatenate([A, [[0, 0, 1.0]]], 0)
    M_u_inv = np.array([[2.0, 0, -1.0], [0, 2.0, -1.0], [0, 0, 1]])
    M_p = np.array([[w / 2.0, 0, (w - 1) / 2.0], [0, h / 2.0, (h - 1) / 2.0],
                    [0, 0, 1]])
    full = M_u_inv @ A3 @ M_p
    return full[:2].astype(np.float32)


# ---------------------------------------------------------------------------
# Skeleton features (upstream modeling/skeleton_feat.py genSkeletons)
# ---------------------------------------------------------------------------


def gen_skeleton_feats(kpts_unit: np.ndarray, size: int,
                       sigma: float = 3.0, limb_width: float = 1.0,
                       ) -> np.ndarray:
    """One person's aligned pose [17, 3] (unit frame, x, y, visibility) ->
    [size, size, 55]: 17 Gaussian heatmaps (sigma in output px), then per
    COCO limb 2 part-affinity channels (the unit limb direction within
    ``limb_width`` px of the segment)."""
    k = kpts_unit.shape[0]
    # align_corners=False: unit-frame u is crop pixel u * size - 0.5, so
    # the skeleton registers with the aligned features
    pts = kpts_unit[:, :2] * size - 0.5
    vis = kpts_unit[:, 2] > 0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.zeros((size, size, k + 2 * len(COCO_SKELETON)), np.float32)
    for i in range(k):
        if not vis[i]:
            continue
        d2 = (xx - pts[i, 0]) ** 2 + (yy - pts[i, 1]) ** 2
        out[:, :, i] = np.exp(-d2 / (2.0 * sigma * sigma))
    for li, (a, b) in enumerate(COCO_SKELETON):
        if not (vis[a] and vis[b]):
            continue
        pa, pb = pts[a], pts[b]
        v = pb - pa
        norm = float(np.hypot(v[0], v[1]))
        if norm < 1e-6:
            continue
        u = v / norm
        dx = xx - pa[0]
        dy = yy - pa[1]
        along = dx * u[0] + dy * u[1]
        across = np.abs(dx * u[1] - dy * u[0])
        on = (along >= 0) & (along <= norm) & (across <= limb_width)
        out[:, :, k + 2 * li] = np.where(on, u[0], 0.0)
        out[:, :, k + 2 * li + 1] = np.where(on, u[1], 0.0)
    return out


def skeleton_feats_for_person(kpts_px: np.ndarray, A: np.ndarray,
                              cfg: Pose2SegConfig) -> np.ndarray:
    """Keypoints in canvas px + the image -> unit affine -> [align, align,
    55]."""
    kp = kpts_px.astype(np.float64).copy()
    kp[:, :2] = kp[:, :2] @ A[:, :2].T + A[:, 2]
    return gen_skeleton_feats(kp, cfg.align_size)


def person_inputs(keypoints: np.ndarray, cfg: Pose2SegConfig,
                  scale: float) -> dict:
    """Up to ``max_people`` people's keypoints [n, 17, 3] in image px and
    the image -> canvas scale -> the heads' inputs for one image, padded to
    ``max_people`` slots (numpy, batch axis 1): theta, inv_theta,
    person_valid and skel. A person whose pose no template solves stays
    invalid, with zero theta and features."""
    p, o = cfg.max_people, cfg.align_size
    out = {"theta": np.zeros((1, p, 2, 3), np.float32),
           "inv_theta": np.zeros((1, p, 2, 3), np.float32),
           "person_valid": np.zeros((1, p), bool),
           "skel": np.zeros((1, p, o, o, cfg.skeleton_channels), np.float32)}
    s = cfg.input_size
    for i, kp_raw in enumerate(keypoints[:p]):
        kp = kp_raw.astype(np.float64).copy()
        kp[:, :2] *= scale
        A, _, _ = choose_template(kp, cfg)
        if A is None:
            continue
        out["theta"][0, i] = affine_to_theta(A, s, s)
        out["inv_theta"][0, i] = inverse_theta(A, s, s)
        out["person_valid"][0, i] = True
        if cfg.cat_skeleton:
            out["skel"][0, i] = skeleton_feats_for_person(kp, A, cfg)
    return out


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class ResNetFPN(ResNetTV):
    """Upstream's resnet50FPN: the ResNet (:class:`ResNetTV`, dilated C5)
    and the FPN convs side by side in one module; the top-down path
    upsamples bilinearly with half-pixel centres, as
    ``jax.image.resize(..., "linear", antialias=False)`` does, and only P2
    (``smooth3``) is computed; ``smooth1`` and ``smooth2`` exist for the
    checkpoint. ``width`` is the ResNet's stem width (64 for R-50)."""

    def __init__(self, dilation_c5: int, channels: int, width: int = 64):
        super().__init__(50, width, dilation_c5)
        c2, c3, c4, c5 = self.out_channels
        self.toplayer = nn.Conv2d(c5, channels, 1)
        self.latlayer1 = nn.Conv2d(c4, channels, 1)
        self.latlayer2 = nn.Conv2d(c3, channels, 1)
        self.latlayer3 = nn.Conv2d(c2, channels, 1)
        for i in (1, 2, 3):
            self.add_module(f"smooth{i}",
                            nn.Conv2d(channels, channels, 3, padding=1))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 3, S, S] normalised -> P2 [B, C, S/4, S/4]."""
        c2, c3, c4, c5 = super().forward(images)

        def up(x, ref):
            return F.interpolate(x, size=ref.shape[-2:], mode="bilinear",
                                 align_corners=False)

        p5 = self.toplayer(c5)
        p4 = self.latlayer1(c4) + up(p5, c4)
        p3 = self.latlayer2(c3) + up(p4, c3)
        p2 = self.latlayer3(c2) + up(p3, c2)
        return self.smooth3(p2)


class SegModule(nn.Module):
    """Upstream's resnet10units: conv + BN + ReLU, ``units`` torchvision
    bottlenecks (``channels`` -> ``channels / 4`` -> ``channels``), a 1x1
    2-class classifier: [N, cin, O, O] -> [N, 2, O, O] logits."""

    def __init__(self, cin: int, channels: int, units: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, channels, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels)
        self.layers = nn.Sequential(*(
            BottleneckTV(channels, channels // 4, channels, 1, False, 1e-5)
            for _ in range(units)))
        self.conv2 = nn.Conv2d(channels, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.layers(F.relu(self.bn1(self.conv1(x)))))


def paste(fg: torch.Tensor, inv_theta: torch.Tensor,
          size: int) -> torch.Tensor:
    """The foreground crops [N, O, O] sampled over a size x size grid of the
    canvas under ``inv_theta`` [N, 2, 3] -> [N, size, size] in fg's dtype,
    computed in theta's (f32) as the JAX package's dense ``grid_sample``:
    bilinear, zero padding, ``align_corners=False``."""
    grid = affine_grid(inv_theta, size, size)
    out = F.grid_sample(fg[:, None].to(grid.dtype), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, 0].to(fg.dtype)


class Pose2Seg(nn.Module):
    def __init__(self, cfg: Pose2SegConfig = Pose2SegConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.feature_channels
        self.backbone = ResNetFPN(cfg.dilation_c5, c)
        self.segnet = SegModule(
            c + (cfg.skeleton_channels if cfg.cat_skeleton else 0), c,
            cfg.seg_units)

    def forward(self, images: torch.Tensor, theta: torch.Tensor,
                inv_theta: torch.Tensor, person_valid: torch.Tensor,
                skel_feats: torch.Tensor | None = None) -> dict:
        """images [B, 3, S, S] normalised; theta, inv_theta [B, P, 2, 3]
        (the crop and the paste); person_valid [B, P]; skel_feats [B, P,
        O, O, 55] (needed with ``cat_skeleton``) -> aligned_logits [B, P,
        O, O, 2] and masks [B, P, paste, paste] foreground probabilities."""
        return self.forward_from_features(self.backbone(images), theta,
                                          inv_theta, person_valid,
                                          skel_feats)

    def heads(self, feats: torch.Tensor, theta: torch.Tensor,
              skel_feats: torch.Tensor | None = None) -> torch.Tensor:
        """AffineAlign + SegModule on P2 [B, C, H, W] -> aligned logits
        [B, P, O, O, 2]."""
        cfg = self.cfg
        b, p = theta.shape[:2]
        o = cfg.align_size
        x = affine_align(feats, theta, o).reshape(b * p, o, o, -1)
        if cfg.cat_skeleton:
            if skel_feats is None:
                raise ValueError("cat_skeleton is on: pass skel_feats")
            x = torch.cat([x, skel_feats.reshape(b * p, o, o, -1)
                           .to(x.dtype)], dim=-1)
        logits = self.segnet(x.permute(0, 3, 1, 2))  # channels-last NCHW
        return logits.permute(0, 2, 3, 1).reshape(b, p, o, o, 2)

    def forward_from_features(self, feats: torch.Tensor, theta: torch.Tensor,
                              inv_theta: torch.Tensor,
                              person_valid: torch.Tensor,
                              skel_feats: torch.Tensor | None = None) -> dict:
        """:meth:`forward` on P2 features computed once: a crowded image
        runs its people in chunks over one backbone pass."""
        b, p = theta.shape[:2]
        o, ps = self.cfg.align_size, self.cfg.paste_size
        logits = self.heads(feats, theta, skel_feats)
        fg = torch.softmax(logits, -1)[..., 1]
        masks = paste(fg.reshape(b * p, o, o), inv_theta.reshape(b * p, 2, 3),
                      ps).reshape(b, p, ps, ps)
        masks = torch.where(person_valid[:, :, None, None], masks,
                            torch.zeros_like(masks))
        return {"aligned_logits": logits, "masks": masks}


def build_model(cfg: Pose2SegConfig = Pose2SegConfig(),
                generator: torch.Generator | None = None) -> Pose2Seg:
    """A CPU model in eval mode: random weights from ``generator`` if one
    is given (conv weights N(0, 1/fan_in), biases 0, BatchNorm the
    identity), otherwise uninitialised storage for ``load_state_dict``."""
    with torch.device("meta"):
        model = Pose2Seg(cfg)
    model = model.to_empty(device="cpu")
    if generator is not None:
        init_weights(model, generator)
    return model.eval()


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("bias", "running_mean", "num_batches_tracked")):
                t.zero_()
            elif t.ndim == 4:
                t.normal_(0.0, t[0].numel() ** -0.5, generator=generator)
            else:  # BN weight and running_var
                t.fill_(1.0)
