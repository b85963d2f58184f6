"""SSD-style training augmentation for YOLACT (the port's copy of
``tpuseg/data/augment.py``, upstream Yolact ``utils/augmentations.py``),
without cv2, so that training runs where OpenCV is not installed.

photometric distort -> expand -> random sample crop -> random mirror ->
resize to the square train size -> normalise, on (RGB float image, xyxy
pixel boxes, classes, masks [N, H, W]) together. Every stage draws from
the caller's ``numpy.random.Generator`` in the JAX package's order, so one
seed gives the same augmentation in both. cv2's two colour conversions are
written out with its float formulas (:func:`rgb_to_hsv`,
:func:`hsv_to_rgb`); its bilinear resizes are ``F.interpolate`` on the CPU
(:func:`resize_bilinear`), which computes the same half-pixel-centred
interpolation in float (cv2 itself takes a 2x2 mean at an exact halving,
the same values).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_EPS = np.float32(np.finfo(np.float32).eps)  # cv2's FLT_EPSILON


class AugmentConfig:
    def __init__(self, size=550, mean=(123.68, 116.78, 103.94),
                 std=(58.40, 57.12, 57.38),
                 discard_box_width=4 / 550, discard_box_height=4 / 550):
        self.size = size
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        # upstream Resize's discard thresholds, in pixels of the resized
        # image: boxes the crop clipped to ~zero extent are dropped
        self.discard_box_width = discard_box_width
        self.discard_box_height = discard_box_height


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """float32 RGB [H, W, 3] -> HSV as ``cv2.cvtColor(COLOR_RGB2HSV)`` on
    float input: H in [0, 360) degrees, S = (V - min) / (|V| + eps), V =
    max, hue scaled by 60 / (V - min + eps) (eps = FLT_EPSILON; the
    brightness jitter leaves pixels below 0, where |V| matters)."""
    r, g, b = (img[..., i] for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _EPS)
    k = np.float32(60.0) / (diff + _EPS)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + np.float32(120.0),
                          (r - g) * k + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], -1).astype(np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rgb_to_hsv`, ``cv2.cvtColor(COLOR_HSV2RGB)`` on
    float input: the hue taken modulo 360 into six sectors, each channel
    one of v, v(1 - s), v(1 - s f), v(1 - s(1 - f)) by its sector."""
    h, s, v = (hsv[..., i] for i in range(3))
    h = np.mod(h * np.float32(6.0 / 360.0), np.float32(6.0))
    sector = np.floor(h)
    f = h - sector
    sector = sector.astype(np.int64) % 6
    tab = np.stack([v, v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))],
                   -1)
    # per sector, the entry of tab that R, G and B take
    pick = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0], [3, 1, 0],
                     [0, 1, 2]])[sector]
    return np.take_along_axis(tab, pick, -1).astype(np.float32)


def resize_bilinear(a: np.ndarray, size) -> np.ndarray:
    """[H, W] or [H, W, C] float32 -> [size, size(, C)] (or [h, w(, C)]
    for ``size`` = (h, w)): bilinear with half-pixel centres and edge
    clamping, no antialiasing (``cv2.resize(INTER_LINEAR)`` on float32)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    t = t[None, None] if t.ndim == 2 else t.permute(2, 0, 1)[None]
    hw = (size, size) if isinstance(size, int) else tuple(size)
    out = F.interpolate(t, size=hw, mode="bilinear",
                        align_corners=False, antialias=False)[0]
    return (out[0] if a.ndim == 2 else out.permute(1, 2, 0)).numpy()


def photometric_distort(rng, img):
    """PhotometricDistort (ssd.pytorch via yolact): float throughout (no
    uint8 rounding between steps), hue jitter +-18 degrees, contrast before
    or after the HSV steps with 50 % each, then the random channel swap."""
    img = img.astype(np.float32)
    if rng.random() < 0.5:  # RandomBrightness(32)
        img += rng.uniform(-32, 32)

    def contrast(im):
        if rng.random() < 0.5:  # RandomContrast(0.5, 1.5)
            im = im * rng.uniform(0.5, 1.5)
        return im

    contrast_first = rng.random() < 0.5
    if contrast_first:
        img = contrast(img)
    hsv = rgb_to_hsv(img)
    if rng.random() < 0.5:  # RandomSaturation(0.5, 1.5)
        hsv[:, :, 1] *= rng.uniform(0.5, 1.5)
    if rng.random() < 0.5:  # RandomHue(18.0) with the reference's wrap
        hsv[:, :, 0] += rng.uniform(-18, 18)
        hsv[:, :, 0][hsv[:, :, 0] > 360.0] -= 360.0
        hsv[:, :, 0][hsv[:, :, 0] < 0.0] += 360.0
    img = hsv_to_rgb(hsv)
    if not contrast_first:
        img = contrast(img)
    if rng.random() < 0.5:  # RandomLightingNoise: a random channel order
        perms = ((0, 1, 2), (0, 2, 1), (1, 0, 2),
                 (1, 2, 0), (2, 0, 1), (2, 1, 0))
        img = img[:, :, perms[rng.integers(len(perms))]]
    return img


def expand(rng, img, boxes, masks, mean):
    if rng.random() < 0.5:
        return img, boxes, masks
    h, w, c = img.shape
    ratio = rng.uniform(1.0, 4.0)
    left = rng.uniform(0, w * ratio - w)
    top = rng.uniform(0, h * ratio - h)
    eh, ew = int(h * ratio), int(w * ratio)
    out = np.empty((eh, ew, c), img.dtype)
    out[:] = mean
    t, l = int(top), int(left)
    out[t:t + h, l:l + w] = img
    boxes = boxes.copy()
    boxes[:, 0::2] += l
    boxes[:, 1::2] += t
    if len(masks):
        m = np.zeros((len(masks), eh, ew), masks.dtype)
        m[:, t:t + h, l:l + w] = masks
        masks = m
    return out, boxes, masks


def random_sample_crop(rng, img, boxes, classes, masks, max_tries=50,
                       iscrowd=None):
    """RandomSampleCrop: a min-IoU mode, then crops tried until one keeps a
    gt centre (and a non-crowd gt). The reference's min-IoU constraint is
    a documented no-op (kept on purpose upstream), so crops are accepted
    on the centre test alone."""
    h, w = img.shape[:2]
    modes = (None, 0.1, 0.3, 0.7, 0.9, -1.0)
    mode = modes[rng.integers(len(modes))]
    if mode is None or len(boxes) == 0:
        return img, boxes, classes, masks, iscrowd
    for _ in range(max_tries):
        cw = rng.uniform(0.3 * w, w)
        chh = rng.uniform(0.3 * h, h)
        if chh / cw < 0.5 or chh / cw > 2:
            continue
        left = rng.uniform(0, w - cw)
        top = rng.uniform(0, h - chh)
        rect = np.array([left, top, left + cw, top + chh])
        centers = (boxes[:, :2] + boxes[:, 2:]) / 2
        keep = ((centers[:, 0] > rect[0]) & (centers[:, 0] < rect[2])
                & (centers[:, 1] > rect[1]) & (centers[:, 1] < rect[3]))
        if not keep.any():
            continue
        if iscrowd is not None and not (keep & ~iscrowd).any():
            continue
        l, t, r, btm = rect.astype(int)
        img = img[t:btm, l:r]
        boxes = boxes[keep].copy()
        boxes[:, 0::2] = np.clip(boxes[:, 0::2] - l, 0, r - l)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2] - t, 0, btm - t)
        classes = classes[keep]
        if iscrowd is not None:
            iscrowd = iscrowd[keep]
        if len(masks):
            masks = masks[keep][:, t:btm, l:r]
        return img, boxes, classes, masks, iscrowd
    return img, boxes, classes, masks, iscrowd


def random_mirror(rng, img, boxes, masks):
    if rng.random() < 0.5:
        w = img.shape[1]
        img = img[:, ::-1]
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        if len(masks):
            masks = masks[:, :, ::-1]
    return img, boxes, masks


def ssd_augment(rng: np.random.Generator, img_rgb_u8: np.ndarray,
                boxes: np.ndarray, classes: np.ndarray, masks: np.ndarray,
                cfg: AugmentConfig, iscrowd: np.ndarray | None = None):
    """SSDAugmentation -> (image [S, S, 3] float32 normalised, boxes
    normalised xyxy, classes, masks [N, S, S] uint8[, iscrowd]); crowds
    ride along through the crop's filter."""
    img = photometric_distort(rng, img_rgb_u8)
    img, boxes, masks = expand(rng, img, boxes, masks, cfg.mean)
    img, boxes, classes, masks, iscrowd = random_sample_crop(
        rng, img, boxes, classes, masks, iscrowd=iscrowd)
    img, boxes, masks = random_mirror(rng, img, boxes, masks)
    h, w = img.shape[:2]
    img = resize_bilinear(img, cfg.size)
    if len(masks):
        masks = np.stack([resize_bilinear(m, cfg.size) > 0.5
                          for m in masks]).astype(np.uint8)
    boxes = boxes.astype(np.float32).copy()
    boxes[:, 0::2] /= w
    boxes[:, 1::2] /= h
    # Resize's discard of boxes below a few pixels after the resize
    if len(boxes):
        bw = (boxes[:, 2] - boxes[:, 0]) * cfg.size
        bh = (boxes[:, 3] - boxes[:, 1]) * cfg.size
        keep = (bw > cfg.discard_box_width) & (bh > cfg.discard_box_height)
        boxes, classes = boxes[keep], classes[keep]
        masks = masks[keep] if len(masks) else masks
        if iscrowd is not None:
            iscrowd = iscrowd[keep]
    img = (img - cfg.mean) / cfg.std
    if iscrowd is not None:
        return img.astype(np.float32), boxes, classes, masks, iscrowd
    return img.astype(np.float32), boxes, classes, masks
