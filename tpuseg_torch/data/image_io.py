"""Host-side image decode, encode and drawing (the port's copy of
``load_image_bgr`` and ``save_image_bgr`` from ``tpuseg/data/image_io.py``).

PIL, imported only when a function is called; the port does not use cv2,
so that it runs where OpenCV is not installed. Images are uint8 BGR HWC
(the detectron convention). Decoding applies the EXIF orientation, as
``cv2.imread`` does by default.
"""
from __future__ import annotations

import numpy as np


def load_image_bgr(path: str) -> np.ndarray:
    """Decode an image file -> uint8 BGR HWC."""
    from PIL import Image, ImageOps

    with Image.open(path) as im:
        rgb = np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
    return np.ascontiguousarray(rgb[:, :, ::-1])


def save_image_bgr(path: str, img_bgr: np.ndarray) -> None:
    """Encode a uint8 BGR HWC image; the format follows the extension."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(img_bgr[:, :, ::-1])).save(path)


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
