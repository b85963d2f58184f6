"""Input conventions (copied from ``tpuseg/ops/preprocess.py``, which
imports jax).

Detectron: BGR input, shortest edge to ``min_size`` capped by
``max_size``, mean subtraction without std. YOLACT: RGB input, a square
bilinear resize, ``(x - mean) / std``. YOLOv3: RGB letterbox to 416/608,
/255. ViT: RGB, a square bilinear resize, ``(x / 255 - 0.5) / 0.5``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuseg_torch.ops.sampling import _true_div

# maskrcnn-benchmark default PIXEL_MEAN (BGR order, used on BGR images)
DETECTRON_PIXEL_MEAN_BGR = (102.9801, 115.9465, 122.7717)
# yolact data/config.py MEANS=(103.94,116.78,123.68) STD=(57.38,57.12,58.40)
# are BGR; the net consumes RGB (FastBaseTransform flips after normalize)
YOLACT_MEAN_RGB = (123.68, 116.78, 103.94)
YOLACT_STD_RGB = (58.40, 57.12, 57.38)


def detectron_target_size(h: int, w: int, min_size: int = 800,
                          max_size: int = 1333):
    """maskrcnn-benchmark Resize.get_size: shortest edge -> min_size capped."""
    size = min_size
    mx = max(h, w)
    mn = min(h, w)
    if mx / mn * size > max_size:
        size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def yolact_preprocess(images_u8: torch.Tensor, size: int = 550) -> torch.Tensor:
    """uint8 RGB [B, H, W, 3] -> normalised f32 [B, 3, size, size].

    FastBaseTransform: a bilinear resize to (size, size) with half-pixel
    centres and no antialiasing (``jax.image.resize(..., antialias=False)``
    in the JAX package, ``F.interpolate(align_corners=False)`` here), then
    ``(x - mean) / std``. The division is by a tensor on the images'
    device: CUDA PyTorch divides by a Python scalar as a multiplication by
    its rounded reciprocal.
    """
    x = images_u8.permute(0, 3, 1, 2).float()
    if tuple(x.shape[-2:]) != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False)
    mean = torch.tensor(YOLACT_MEAN_RGB, device=x.device)[:, None, None]
    std = torch.tensor(YOLACT_STD_RGB, device=x.device)[:, None, None]
    return (x - mean) / std


def _bilinear_taps(coords: torch.Tensor, in_size: int) -> tuple:
    """coords [B, S] (clamped sample positions) -> the two taps of each
    sample's bilinear row: (floor(c), min(floor(c) + 1, in_size - 1), the
    weight f of the second; the first's is 1 - f), the nonzero entries of
    the JAX ``_bilinear_rows`` one-hot weight matrices."""
    c0 = torch.floor(coords)
    f = coords - c0
    c0 = c0.long()
    return c0, (c0 + 1).clamp(max=in_size - 1), f


def letterbox_preprocess(images_u8: torch.Tensor, hw: torch.Tensor,
                         size: int = 416) -> torch.Tensor:
    """uint8 RGB [B, H, W, 3] zero-padded to a common canvas, with each
    image's true (h, w) in ``hw`` [B, 2] -> f32 [B, 3, size, size] in
    [0, 1] (YOLOv3's letterbox, ``utils/datasets.py``): the longest edge
    scaled to ``size``, centred, the rest 0.5 grey. Each output pixel
    samples its image at ((i + 0.5 - pad) / scale - 0.5), clamped to the
    image's own extent (border replicate, as cv2.resize), bilinearly.

    The JAX package computes the two separable resamplings as batched
    matrix products of one-hot weight rows at ``Precision.HIGHEST``. Each
    row has two nonzero taps, so the port computes each product as its
    two gathers and a weighted sum in f32: there is no matmul, and so
    nothing that TF32 could round, on any device.
    """
    b, ih, iw, _ = images_u8.shape
    dev = images_u8.device
    hw = hw.to(dev)
    h = hw[:, 0].float()
    w = hw[:, 1].float()
    # a true division (a Python scalar over a tensor is a multiplication
    # by the tensor's reciprocal in PyTorch)
    scale = torch.full_like(h, float(size)) / torch.maximum(h, w)
    pad_y = (size - h * scale) * 0.5
    pad_x = (size - w * scale) * 0.5
    grid = torch.arange(size, dtype=torch.float32, device=dev)[None, :]
    sy = (grid + 0.5 - pad_y[:, None]) / scale[:, None] - 0.5  # [B, S]
    sx = (grid + 0.5 - pad_x[:, None]) / scale[:, None] - 0.5
    inside = (((sy > -1.0) & (sy < h[:, None]))[:, :, None]
              & ((sx > -1.0) & (sx < w[:, None]))[:, None, :])
    zero = torch.zeros((), device=dev)
    sy = torch.minimum(sy.clamp(min=0.0),
                       torch.maximum(h - 1.0, zero)[:, None])
    sx = torch.minimum(sx.clamp(min=0.0),
                       torch.maximum(w - 1.0, zero)[:, None])
    img = images_u8.float()
    y0, y1, fy = _bilinear_taps(sy, ih)
    bi = torch.arange(b, device=dev)[:, None]
    rows = ((1.0 - fy)[:, :, None, None] * img[bi, y0]
            + fy[:, :, None, None] * img[bi, y1])  # [B, S, W, C]
    x0, x1, fx = _bilinear_taps(sx, iw)
    out = ((1.0 - fx)[:, None, :, None] * rows[bi, :, x0].transpose(1, 2)
           + fx[:, None, :, None] * rows[bi, :, x1].transpose(1, 2))
    out = _true_div(out, 255.0)
    out = torch.where(inside[..., None], out, torch.full_like(out, 0.5))
    return out.permute(0, 3, 1, 2).contiguous()


def vit_preprocess(images_u8: torch.Tensor, size: int = 224) -> torch.Tensor:
    """uint8 RGB [B, H, W, 3] -> f32 [B, 3, size, size]: a bilinear resize
    with half-pixel centres and no antialiasing (the JAX
    ``resize_bilinear_exact``; none for an image already at ``size``),
    then (x / 255 - 0.5) / 0.5."""
    x = images_u8.permute(0, 3, 1, 2).float()
    if tuple(x.shape[-2:]) != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False)
    return _true_div(_true_div(x, 255.0) - 0.5, 0.5)
