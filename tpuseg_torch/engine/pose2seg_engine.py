"""Pose2Seg predictor and evaluation engine (port of
``tpuseg/engine/pose2seg_engine.py``; Pose2Seg.jittor test.py parity).

:class:`Pose2SegPredictor` runs the model on ``device`` in ``dtype`` (f32
or bf16): the canvas resize on the host (the port's twin of
``cv2.resize(INTER_LINEAR)`` on uint8, ``data/image_io.py::
resize_bilinear_u8``), each person's template, theta and skeleton on the
host (``models/pose2seg.py``), the network on the device, the pasted masks
cropped to the image's part of the canvas and resized to the image there
(half-pixel bilinear ``F.interpolate``, cv2's geometry) and thresholded.
:func:`evaluate_pose2seg` runs COCOeval on segm with the ground-truth
keypoints as the pose input.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.data.image_io import resize_bilinear_u8
from tpuseg_torch.models import pose2seg as P2S
from tpuseg_torch.weights.from_jax import pose2seg_jax_from_state_dict
from tpuseg_torch.weights.npz_io import save_params_npz
from tpuseg_torch.weights.pose2seg_map import load_pose2seg_weights

PIXEL_MEAN = np.asarray([0.485, 0.456, 0.406])  # ImageNet, RGB in [0, 1]
PIXEL_STD = np.asarray([0.229, 0.224, 0.225])


def canvas_image(img_rgb: np.ndarray, size: int, nh: int,
                 nw: int) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> the normalised square canvas [size, size, 3]
    f32: the image resized to nh x nw at the top left, zeros elsewhere,
    then (x / 255 - mean) / std everywhere (in f64, cast once)."""
    canvas = np.zeros((size, size, 3), np.float32)
    canvas[:nh, :nw] = resize_bilinear_u8(img_rgb, nh, nw)
    return ((canvas / 255.0 - PIXEL_MEAN) / PIXEL_STD).astype(np.float32)


class Pose2SegPredictor:
    """Pose2Seg inference on ``device``. Weights: a ``state_dict`` with the
    port's (upstream's) keys, a checkpoint (``weights``, through
    :func:`load_pose2seg_weights`, which may change ``cat_skeleton`` and
    ``seg_units``), or random ones from a ``torch.Generator`` seeded with
    0. ``dtype``: the model's, f32 or bf16."""

    def __init__(self, cfg: P2S.Pose2SegConfig | None = None,
                 state_dict: dict | None = None, weights: str | None = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but CUDA is unavailable")
        cfg = cfg or P2S.Pose2SegConfig()
        if weights:
            state_dict, cfg = load_pose2seg_weights(weights, cfg)
        self.cfg = cfg
        self.dtype = dtype
        model = P2S.build_model(
            cfg, None if state_dict else torch.Generator().manual_seed(0))
        if state_dict:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device, dtype).eval()

    def run_on_image(self, img_rgb: np.ndarray, keypoints: np.ndarray) -> dict:
        """img uint8 RGB [H, W, 3]; keypoints [N, 17, 3] in image px ->
        {masks [N, H, W] uint8, valid [N]}. More than ``max_people`` people
        run in chunks of ``max_people`` over one backbone pass."""
        cfg = self.cfg
        h, w = img_rgb.shape[:2]
        s, p = cfg.input_size, cfg.max_people
        scale = s / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        canvas = canvas_image(img_rgb, s, nh, nw)
        images = torch.from_numpy(canvas).permute(2, 0, 1)[None].to(
            self.device, self.dtype)
        n = len(keypoints)
        chunks, valid = [], np.zeros((n,), bool)
        with torch.inference_mode():
            feats = self.model.backbone(images) if n > p else None
            for c0 in range(0, n, p):
                chunk = keypoints[c0:c0 + p]
                inp = P2S.person_inputs(chunk, cfg, scale)
                valid[c0:c0 + len(chunk)] = inp["person_valid"][0, :len(chunk)]
                x = {k: torch.from_numpy(v).to(self.device)
                     for k, v in inp.items()}
                args = (x["theta"], x["inv_theta"], x["person_valid"],
                        x["skel"])
                out = (self.model(images, *args) if feats is None
                       else self.model.forward_from_features(feats, *args))
                chunks.append(out["masks"][0, :len(chunk)])
            if not chunks:
                return {"masks": np.zeros((0, h, w), np.uint8),
                        "valid": valid}
            # the paste grid covers the square canvas, coarser: crop the
            # image's part at paste scale, then resize to the image
            ps = cfg.paste_size
            ph = max(int(round(nh * ps / s)), 1)
            pw = max(int(round(nw * ps / s)), 1)
            masks = torch.cat(chunks)[:, None, :ph, :pw].float()
            masks = F.interpolate(masks, size=(h, w), mode="bilinear",
                                  align_corners=False)[:, 0]
            masks = (masks > cfg.mask_thresh).to(torch.uint8).cpu().numpy()
        return {"masks": masks, "valid": valid}


def save_pose2seg_checkpoint(path: str, model: torch.nn.Module) -> None:
    """The model's state_dict itself, upstream's keys, CPU tensors (a torch
    zip file); a ``path`` ending in ``.npz`` gets the JAX package's param
    tree instead, as its ``pose2seg_train`` writes it.
    :func:`load_pose2seg_weights` reads either back."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if path.endswith(".npz"):
        save_params_npz(path, pose2seg_jax_from_state_dict(sd))
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(sd, path)


def image_keypoints(dataset, image_id: int) -> np.ndarray:
    """The annotations' keypoints of an image with at least two visible,
    [n, 17, 3] f64 (test.py's pose input)."""
    kpts = [np.asarray(a["keypoints"], np.float64).reshape(-1, 3)
            for a in dataset.coco.imgToAnns[image_id]
            if a.get("keypoints") is not None
            and np.sum(np.asarray(a["keypoints"]).reshape(-1, 3)[:, 2] > 0)
            >= 2]
    return np.asarray(kpts)


def evaluate_pose2seg(predictor, dataset, max_images=None, progress=True):
    """COCOeval segm over a keypoint dataset (test.py parity): each person
    with a solved pose is a detection of category 1 with score 1 ->
    COCOeval's stats."""
    from tpuseg_torch.eval import rle as rle_mod
    from tpuseg_torch.eval.cocoeval import COCOeval

    ids = dataset.image_ids
    if max_images:
        ids = ids[:max_images]
    results = []
    for n, iid in enumerate(ids, 1):
        kpts = image_keypoints(dataset, iid)
        if len(kpts) == 0:
            continue
        out = predictor.run_on_image(dataset.load_image(iid), kpts)
        for i in range(len(out["masks"])):
            if not out["valid"][i]:
                continue
            results.append({
                "image_id": int(iid),
                "category_id": 1,
                "score": 1.0,
                "segmentation": rle_mod.encode(out["masks"][i]),
            })
        if progress and n % 10 == 0:
            print(f"\r{n}/{len(ids)}", end="", flush=True)
    if progress:
        print()
    E = COCOeval(dataset.coco, dataset.coco.loadRes(results), "segm")
    E.evaluate()
    E.accumulate()
    E.summarize()
    return E.stats
