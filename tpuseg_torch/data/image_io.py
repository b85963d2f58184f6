"""Host-side image decode and encode (the port's copy of
``load_image_bgr`` and ``save_image_bgr`` from ``tpuseg/data/image_io.py``).

cv2 where it is installed, PIL otherwise; each is imported only when a
function is called. Images are uint8 BGR HWC (the detectron convention).
Decoding applies the EXIF orientation, as ``cv2.imread`` does by default.
"""
from __future__ import annotations

import numpy as np


def load_image_bgr(path: str) -> np.ndarray:
    """Decode an image file -> uint8 BGR HWC."""
    try:
        import cv2
    except ImportError:
        from PIL import Image, ImageOps

        with Image.open(path) as im:
            rgb = np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
        return np.ascontiguousarray(rgb[:, :, ::-1])
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cv2 failed to read {path}")
    return img


def save_image_bgr(path: str, img_bgr: np.ndarray) -> None:
    """Encode a uint8 BGR HWC image; the format follows the extension."""
    try:
        import cv2
    except ImportError:
        from PIL import Image

        Image.fromarray(np.ascontiguousarray(img_bgr[:, :, ::-1])).save(path)
        return
    if not cv2.imwrite(path, img_bgr):
        raise IOError(f"cv2 failed to write {path}")
