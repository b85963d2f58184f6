"""Frozen copy of the port's ``tpuseg_torch/ops/preprocess.py`` (plain paths only),
for the benchmark's reference; it imports nothing of the port.

Input conventions (copied from ``tpuseg/ops/preprocess.py``, which
imports jax).

Detectron: BGR input, shortest edge to ``min_size`` capped by
``max_size``, mean subtraction without std. YOLACT: RGB input, a square
bilinear resize, ``(x - mean) / std``. YOLOv3: RGB letterbox to 416/608,
/255. ViT: RGB, a square bilinear resize, ``(x / 255 - 0.5) / 0.5``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


