"""Mask R-CNN predictor (port of ``tpuseg/engine/maskrcnn_engine.py``, FPN
variant).

Host side: shortest-edge-800 resize (PIL bilinear, only when the size
changes), BGR mean subtraction, placement on one of two static canvases
(landscape 800x1344, portrait 1344x800). Device side: the model's forward
on ``device``. Post: the 28x28 masks pasted into image coordinates with
upstream Masker semantics.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.ops.preprocess import (DETECTRON_PIXEL_MEAN_BGR,
                                         detectron_target_size)


def preprocess_image_bgr(img_bgr: np.ndarray, min_size=800, max_size=1333):
    """-> (canvas float32 [Hc, Wc, 3], (th, tw) real size, (sy, sx) scales).

    The canvas is (min_size, ceil64(max_size)) or its transpose. PIL is
    imported only when the image must be resized.
    """
    h, w = img_bgr.shape[:2]
    th, tw = detectron_target_size(h, w, min_size, max_size)
    long_edge = -(-max_size // 64) * 64
    # extreme aspect ratios can round the long edge past max_size
    th, tw = min(th, long_edge), min(tw, long_edge)
    canvas_hw = (min_size, long_edge) if tw >= th else (long_edge, min_size)
    if (th, tw) == (h, w):
        resized = img_bgr
    else:
        from PIL import Image

        pil = Image.fromarray(np.ascontiguousarray(img_bgr[:, :, ::-1]))
        resized = np.asarray(pil.resize((tw, th), Image.BILINEAR))[:, :, ::-1]
    canvas = np.zeros((*canvas_hw, 3), np.float32)
    canvas[:th, :tw] = resized.astype(np.float32) - np.asarray(
        DETECTRON_PIXEL_MEAN_BGR, np.float32)
    return canvas, (th, tw), (th / h, tw / w)


def paste_masks(masks28: torch.Tensor, boxes: torch.Tensor, im_h: int,
                im_w: int, thresh: float = 0.5, padding: int = 1) -> torch.Tensor:
    """Masker: [n, 28, 28] probabilities and [n, 4] image-coordinate boxes
    -> [n, im_h, im_w] uint8 masks on the masks' device.

    Each mask is zero-padded by ``padding``, its box expanded by the same
    factor and truncated to integers, the mask resized to the box with
    bilinear interpolation (half-pixel centres, as upstream's
    ``F.interpolate(align_corners=False)``), thresholded at ``thresh`` and
    placed, clipped to the image.
    """
    n, m = masks28.shape[0], masks28.shape[-1]
    out = torch.zeros((n, im_h, im_w), dtype=torch.uint8, device=masks28.device)
    if n == 0:
        return out
    padded = F.pad(masks28.float(), (padding,) * 4)
    scale = (m + 2 * padding) / m
    boxes = boxes.float()
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5 * scale
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5 * scale
    x_c = (boxes[:, 2] + boxes[:, 0]) * 0.5
    y_c = (boxes[:, 3] + boxes[:, 1]) * 0.5
    ebox = torch.stack([x_c - w_half, y_c - h_half, x_c + w_half,
                        y_c + h_half], 1).to(torch.int64).tolist()
    for i, (ex0, ey0, ex1, ey1) in enumerate(ebox):
        w = max(ex1 - ex0 + 1, 1)
        h = max(ey1 - ey0 + 1, 1)
        resized = F.interpolate(padded[i][None, None], size=(h, w),
                                mode="bilinear", align_corners=False)[0, 0]
        x0, x1 = max(ex0, 0), min(ex1 + 1, im_w)
        y0, y1 = max(ey0, 0), min(ey1 + 1, im_h)
        if x1 > x0 and y1 > y0:
            out[i, y0:y1, x0:x1] = (
                resized[y0 - ey0:y1 - ey0, x0 - ex0:x1 - ex0] > thresh)
    return out


class MaskRCNNPredictor:
    """COCODemo-equivalent programmatic API on ``device``.

    Weights: an upstream ``.pth`` (``weights``), a ready ``model``, or random
    weights from a ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(self, cfg: M.MaskRCNNConfig | None = None,
                 weights: str | None = None, model: M.MaskRCNN | None = None,
                 confidence_threshold: float = 0.5, min_image_size: int = 800,
                 max_image_size: int = 1333, device="cuda", seed: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is unavailable")
        if model is None:
            cfg = cfg or M.MaskRCNNConfig()
            if weights:
                from tpuseg_torch.weights.detectron_map import (
                    load_detectron_weights)

                model = load_detectron_weights(weights, M.build_model(cfg))
            else:
                model = M.build_model(
                    cfg, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.cfg = self.model.cfg
        self.confidence_threshold = confidence_threshold
        self.min_image_size = min_image_size
        self.max_image_size = max_image_size

    def run_on_bgr_image(self, img_bgr: np.ndarray) -> dict:
        """Single image -> final detections in original-image coords."""
        return self.run_on_bgr_images([img_bgr])[0]

    def run_on_bgr_images(self, imgs_bgr: list) -> list:
        """Batched inference; the images must share one canvas orientation.
        Returns, per image, numpy ``boxes``, ``scores``, ``classes`` (0-based)
        and ``masks`` [n, h, w] uint8."""
        canvases, hws, scales = [], [], []
        for img in imgs_bgr:
            canvas, hw, scale = preprocess_image_bgr(
                img, self.min_image_size, self.max_image_size)
            canvases.append(canvas)
            hws.append(hw)
            scales.append(scale)
        if len({c.shape for c in canvases}) != 1:
            raise ValueError("a batch must share one canvas orientation")
        images = torch.from_numpy(
            np.stack(canvases).transpose(0, 3, 1, 2).copy()).to(self.device)
        image_hw = torch.tensor(hws, dtype=torch.int64, device=self.device)
        with torch.inference_mode():
            out = M.forward_inference(self.model, images, image_hw)
            results = []
            for i, img in enumerate(imgs_bgr):
                h, w = img.shape[:2]
                valid = out["valid"][i]
                sy, sx = scales[i]
                boxes = out["boxes"][i][valid].clone()
                boxes[:, 0::2] = (boxes[:, 0::2] / sx).clamp(0, w - 1)
                boxes[:, 1::2] = (boxes[:, 1::2] / sy).clamp(0, h - 1)
                res = {"boxes": boxes, "scores": out["scores"][i][valid],
                       "classes": out["classes"][i][valid],
                       "masks": paste_masks(out["masks"][i][valid], boxes, h, w)}
                results.append({k: v.cpu().numpy() for k, v in res.items()})
        return results

    def select_top_predictions(self, preds: dict) -> dict:
        keep = preds["scores"] >= self.confidence_threshold
        order = np.argsort(-preds["scores"][keep], kind="stable")
        return {k: v[keep][order] for k, v in preds.items()}
