"""The plain reference of YOLACT++ R-50-FPN's stream cells, as a user of
the predictor receives each frame: FastBaseTransform, the model, Detect
with Fast-NMS and FastMaskIoUNet rescoring, and upstream's ``postprocess``
(the masks upsampled to the image with half-pixel bilinear interpolation
on the host, binarised at 0.5, the boxes scaled to pixels and truncated),
in float32 with TF32 off. It imports nothing of the port."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import yolactpp_r50 as R
from benchmark.reference.exact import float32_exact
from benchmark.reference.frozen import yolact as Y
from benchmark.reference.frozen.preprocess import yolact_preprocess


def postprocess(det: dict, h: int, w: int) -> dict:
    """One image's padded detections (numpy) -> what the user receives,
    and ``cell``: a prototype pixel's height and width in the image."""
    valid = det["valid"] & (det["scores"] > 0.0)
    masks = torch.from_numpy(np.ascontiguousarray(det["masks"][valid]))
    if len(masks):
        masks = F.interpolate(masks[:, None].float(), size=(h, w),
                              mode="bilinear", align_corners=False)[:, 0]
    masks = (masks > 0.5).numpy().astype(np.uint8).reshape(-1, h, w)
    px = det["boxes"][valid] * np.asarray([w, h, w, h], np.float32)
    px[:, 0::2] = np.clip(px[:, 0::2], 0, w)
    px[:, 1::2] = np.clip(px[:, 1::2], 0, h)
    return {"boxes": px.astype(np.int64).astype(np.float32),
            "scores": det["scores"][valid], "classes": det["classes"][valid],
            "masks": masks,
            "cell": (h / det["masks"].shape[-2], w / det["masks"].shape[-1]),
            "mask_scores": det["mask_scores"][valid]}


def requests(sizes: dict, state: dict, frames: list, dev):
    """Each frame (uint8 RGB [h, w, 3]) -> its detections, one frame at a
    time (a generator: a frame's masks take 100 x h x w bytes)."""
    cfg = R.model_config(sizes)
    with float32_exact(), torch.no_grad():
        model = R.build(sizes, state, dev)
        priors = torch.from_numpy(Y.make_priors_np(cfg)).to(dev)
        for img in frames:
            x = yolact_preprocess(torch.from_numpy(img[None]).to(dev),
                                  cfg.img_size)
            preds = {k: v.float() for k, v in model(x).items()}
            det = Y.detect(preds, priors, cfg, maskiou_net=model.maskiou_net)
            det = {k: v[0].cpu().numpy() for k, v in det.items()}
            yield postprocess(det, img.shape[0], img.shape[1])

