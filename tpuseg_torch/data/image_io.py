"""Host-side image decode, encode, resize and drawing (the port's copy of
``load_image_rgb``, ``load_image_bgr`` and ``save_image_bgr`` from
``tpuseg/data/image_io.py``).

Decoding is PIL, imported only when a function is called; the port does
not use cv2, so that it runs where OpenCV is not installed. PIL decodes in
the raw pixel frame (the frame COCO annotations live in); where the
display frame is asked for, ``ImageOps.exif_transpose`` applies the EXIF
orientation, as ``cv2.imread`` does by default. :func:`resize_bilinear_u8`
is the numpy twin of the native loader's resize
(``tpuseg_torch/native/tpuseg_loader.cpp``).
"""
from __future__ import annotations

import numpy as np


def load_image_rgb(path: str, *, ignore_orientation: bool = False) -> np.ndarray:
    """Decode an image file -> uint8 RGB HWC array.

    ``ignore_orientation=True`` decodes in the annotation frame (the raw
    pixels, EXIF orientation ignored); dataset loaders use it,
    display/demo paths do not.
    """
    from PIL import Image, ImageOps

    with Image.open(path) as im:
        if not ignore_orientation:
            im = ImageOps.exif_transpose(im)
        return np.ascontiguousarray(np.asarray(im.convert("RGB")))


def load_image_bgr(path: str, *, ignore_orientation: bool = False) -> np.ndarray:
    """Decode -> uint8 BGR HWC (the detectron convention)."""
    return np.ascontiguousarray(load_image_rgb(
        path, ignore_orientation=ignore_orientation)[:, :, ::-1])


def save_image_bgr(path: str, img_bgr: np.ndarray) -> None:
    """Encode a uint8 BGR HWC image; the format follows the extension."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(img_bgr[:, :, ::-1])).save(path)


def _resize_axis(n_src: int, n_dst: int):
    """Source corners and weight of each output pixel along one axis, in
    float32 as the native loader computes them (half-pixel centres, the
    low corner clamped at 0 with weight 0, the high corner at the edge)."""
    s = np.float32(n_src) / np.float32(n_dst)
    f = (np.arange(n_dst, dtype=np.float32) + np.float32(0.5)) * s \
        - np.float32(0.5)
    i0 = np.floor(f).astype(np.int64)
    w = f - i0.astype(np.float32)
    w[i0 < 0] = 0
    i0 = np.maximum(i0, 0)
    return i0, np.minimum(i0 + 1, n_src - 1), w


def resize_bilinear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 [H, W, C] -> [out_h, out_w, C]: bilinear with half-pixel
    centres (``cv2.resize(INTER_LINEAR)``'s geometry), each value rounded
    half up; the numpy twin of ``resize_bilinear`` in
    ``tpuseg_torch/native/tpuseg_loader.cpp``, step for step in float32.
    It meets the native loader to one level (g++ fuses some of its
    multiply-adds, which round once where these round twice)."""
    y0, y1, wy = _resize_axis(img.shape[0], out_h)
    x0, x1, wx = _resize_axis(img.shape[1], out_w)
    one = np.float32(1)
    wx, wy = wx[None, :, None], wy[:, None, None]
    r0 = img[y0].astype(np.float32)
    r1 = img[y1].astype(np.float32)
    top = (one - wx) * r0[:, x0] + wx * r0[:, x1]
    bottom = (one - wx) * r1[:, x0] + wx * r1[:, x1]
    v = (one - wy) * top + wy * bottom
    return (v + np.float32(0.5)).astype(np.uint8)


def draw_detections(img_bgr: np.ndarray, boxes, masks, labels=None,
                    alpha: float = 0.5) -> np.ndarray:
    """A copy of ``img_bgr`` with each detection's mask blended in a
    colour of its own (``alpha`` of the colour), its box outlined 2 px
    wide and, with ``labels``, its label written above the box."""
    from PIL import Image, ImageDraw

    vis = img_bgr.copy()
    rng = np.random.default_rng(0)
    colors = [tuple(int(c) for c in rng.integers(60, 255, 3))
              for _ in range(len(boxes))]
    for m, color in zip(masks, colors):
        m = m.astype(bool)
        vis[m] = ((1 - alpha) * vis[m] + alpha * np.asarray(color)).astype(
            np.uint8)
    im = Image.fromarray(np.ascontiguousarray(vis[:, :, ::-1]))
    draw = ImageDraw.Draw(im)
    for i, (box, color) in enumerate(zip(boxes, colors)):
        x1, y1, x2, y2 = (int(v) for v in box)
        rgb = color[::-1]
        draw.rectangle((x1, y1, x2, y2), outline=rgb, width=2)
        if labels is not None:
            draw.text((x1, max(y1 - 14, 0)), labels[i], fill=rgb)
    return np.ascontiguousarray(np.asarray(im)[:, :, ::-1])
