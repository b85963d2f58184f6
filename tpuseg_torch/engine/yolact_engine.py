"""YOLACT predictor (port of ``tpuseg/engine/yolact_engine.py``).

Device side: ``yolact_preprocess`` (bilinear resize to the square input,
normalisation), the model's forward in ``dtype``, predictions cast to f32,
:func:`~tpuseg_torch.models.yolact.detect`. Host side
(:meth:`YolactPredictor.postprocess_image`): upstream's
``output_utils.postprocess``, the masks upsampled to the image with
half-pixel bilinear interpolation (``F.interpolate``, which equals the
JAX engine's ``cv2.resize(INTER_LINEAR)``), binarised at 0.5, the boxes
scaled to pixels and truncated to integers.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.models import yolact as Y
from tpuseg_torch.ops.preprocess import yolact_preprocess
from tpuseg_torch.weights.yolact_map import load_yolact_weights


class YolactPredictor:
    """YOLACT inference on ``device``. Weights: a ``state_dict`` with
    upstream's keys, an upstream ``.pth`` (``weights``), or random ones from
    a ``torch.Generator`` seeded with 0. ``dtype`` is the model's (f32 or
    bf16); ``batch_size`` the chunk :meth:`predict_images` runs at once."""

    def __init__(self, cfg: Y.YolactConfig, state_dict: dict | None = None,
                 weights: str | None = None, batch_size: int = 1,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but CUDA is unavailable")
        self.cfg = cfg
        self.batch_size = batch_size
        self.dtype = dtype
        if weights:
            state_dict = load_yolact_weights(weights)
        model = Y.build_model(
            cfg, None if state_dict else torch.Generator().manual_seed(0))
        if state_dict:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device, dtype).eval()
        self.priors = torch.from_numpy(Y.make_priors_np(cfg)).to(self.device)

    def run_batch(self, images_u8) -> dict:
        """uint8 RGB [B, H, W, 3] (numpy or tensor; one size for the batch,
        resized to the model's square input on the device) -> detections
        on the device: boxes [B, K, 4] normalised xyxy, scores, classes,
        masks [B, K, Sp, Sp], valid (and mask_scores for YOLACT++)."""
        images = torch.as_tensor(images_u8).to(self.device)
        with torch.inference_mode():
            x = yolact_preprocess(images, self.cfg.img_size).to(self.dtype)
            preds = {k: v.float() for k, v in self.model(x).items()}
            return Y.detect(preds, self.priors, self.cfg,
                            maskiou_net=self.model.maskiou_net)

    def postprocess_image(self, det_i: dict, h: int, w: int,
                          score_threshold: float = 0.0) -> dict:
        """Slot i of a batch (numpy) -> its detections in image coordinates:
        boxes [n, 4] (integer pixels), scores, classes, masks [n, h, w]
        uint8 (and mask_scores)."""
        valid = det_i["valid"] & (det_i["scores"] > score_threshold)
        masks = torch.from_numpy(np.ascontiguousarray(det_i["masks"][valid]))
        if len(masks):
            masks = F.interpolate(masks[:, None].float(), size=(h, w),
                                  mode="bilinear", align_corners=False)[:, 0]
        masks = (masks > 0.5).numpy().astype(np.uint8).reshape(-1, h, w)
        px = det_i["boxes"][valid] * np.asarray([w, h, w, h], np.float32)
        px[:, 0::2] = np.clip(px[:, 0::2], 0, w)
        px[:, 1::2] = np.clip(px[:, 1::2], 0, h)
        out = {"boxes": px.astype(np.int64).astype(np.float32),
               "scores": det_i["scores"][valid],
               "classes": det_i["classes"][valid], "masks": masks}
        if "mask_scores" in det_i:
            out["mask_scores"] = det_i["mask_scores"][valid]
        return out

    def predict_images(self, imgs_rgb: list,
                       score_threshold: float = 0.0) -> list:
        """uint8 RGB images of any sizes -> per image, the detections of
        :meth:`postprocess_image`. Images of one size run ``batch_size`` at
        a time."""
        results = [None] * len(imgs_rgb)
        by_size = {}
        for i, img in enumerate(imgs_rgb):
            by_size.setdefault(img.shape[:2], []).append(i)
        for (h, w), ids in by_size.items():
            for s in range(0, len(ids), self.batch_size):
                chunk = ids[s:s + self.batch_size]
                det = self.run_batch(np.stack([imgs_rgb[i] for i in chunk]))
                det = {k: v.cpu().numpy() for k, v in det.items()}
                for j, i in enumerate(chunk):
                    results[i] = self.postprocess_image(
                        {k: v[j] for k, v in det.items()}, h, w,
                        score_threshold)
        return results
