"""Frozen copy of the port's detectron training batch
(``tpuseg_torch/engine/detectron_train_loop.py``: ``crop_mask``,
``build_train_example``, ``batch_to_device``, the loop's draw order;
``engine/maskrcnn_engine.py::preprocess_image_bgr``;
``data/coco_dataset.py``'s target reading) for the benchmark's reference.
It imports nothing of the port."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import rle
from .preprocess import DETECTRON_PIXEL_MEAN_BGR, detectron_target_size

COCO_CATEGORY_IDS = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90)
# yolact's COCO_LABEL_MAP: the 91-id space onto 1..80, in id order
LABEL_MAP = {c: i + 1 for i, c in enumerate(COCO_CATEGORY_IDS)}


class CocoData:
    """A COCO instances json and its image directory: the ids sorted, each
    image's annotations in the file's order."""

    def __init__(self, image_dir: str, ann_file: str):
        with open(ann_file) as f:
            d = json.load(f)
        self.image_dir = image_dir
        self.imgs = {im["id"]: im for im in d["images"]}
        self.anns = {i: [] for i in self.imgs}
        for a in d["annotations"]:
            self.anns[a["image_id"]].append(a)
        self.image_ids = sorted(self.imgs)

    def load_image(self, iid) -> np.ndarray:
        """RGB uint8, the raw pixel frame."""
        from PIL import Image

        path = os.path.join(self.image_dir, self.imgs[iid]["file_name"])
        with Image.open(path) as im:
            return np.ascontiguousarray(np.asarray(im.convert("RGB")))

    def load_target(self, iid) -> dict:
        h, w = self.imgs[iid]["height"], self.imgs[iid]["width"]
        boxes, classes, masks, crowd = [], [], [], []
        for a in self.anns[iid]:
            x, y, bw, bh = a["bbox"]
            boxes.append([x, y, x + bw, y + bh])
            classes.append(LABEL_MAP[a["category_id"]] - 1)
            crowd.append(int(a.get("iscrowd", 0)))
            masks.append(rle.decode(rle.segm_to_rle(a["segmentation"], h, w)))
        return {"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                "classes": np.asarray(classes, np.int32),
                "iscrowd": np.asarray(crowd, np.int32),
                "masks": (np.stack(masks) if masks
                          else np.zeros((0, h, w), np.uint8))}


def batch_plan(data: CocoData, seed: int, batch: int, steps: int) -> list:
    """The loop's first ``steps`` batches as [[(image id, flipped)]]: the
    ids shuffled per pass by a numpy generator seeded with ``seed``, bucketed
    by orientation until a bucket holds ``batch``, each image's flip drawn
    from the same generator as its example is built (do_train's order)."""
    rng = np.random.default_rng(seed)
    ids = list(data.image_ids)
    buckets = {"landscape": [], "portrait": []}
    plan = []
    while len(plan) < steps:
        rng.shuffle(ids)
        for iid in ids:
            info = data.imgs[iid]
            orient = ("landscape" if info["width"] >= info["height"]
                      else "portrait")
            buckets[orient].append(iid)
            if len(buckets[orient]) < batch:
                continue
            chunk, buckets[orient] = buckets[orient], []
            plan.append([(i, bool(rng.random() < 0.5)) for i in chunk])
            if len(plan) == steps:
                break
    return plan


def preprocess_image_bgr(img_bgr: np.ndarray, min_size=800, max_size=1333):
    """-> (canvas float32 [Hc, Wc, 3], (th, tw), (sy, sx)); the canvas is
    (min_size, ceil64(max_size)) or its transpose."""
    h, w = img_bgr.shape[:2]
    th, tw = detectron_target_size(h, w, min_size, max_size)
    long_edge = -(-max_size // 64) * 64
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


def _bilinear_axis(t: np.ndarray, n: int):
    t0 = np.floor(t)
    f = t - t0
    i0 = t0.astype(np.int64)
    i1 = i0 + 1
    w0 = np.where((i0 >= 0) & (i0 < n), 1.0 - f, 0.0)
    w1 = np.where((i1 >= 0) & (i1 < n), f, 0.0)
    return np.clip(i0, 0, n - 1), np.clip(i1, 0, n - 1), w0, w1


def crop_mask(mask: np.ndarray, box: np.ndarray, crop: int) -> np.ndarray:
    """A gt mask resampled over its float box onto a crop x crop grid,
    bilinear with a zero border."""
    x1, y1, x2, y2 = np.asarray(box, np.float64)
    bw = max(x2 - x1, 1.0)
    bh = max(y2 - y1, 1.0)
    grid = np.arange(crop) + 0.5
    y0, y1i, wy0, wy1 = _bilinear_axis(y1 + grid * bh / crop - 0.5,
                                       mask.shape[0])
    x0, x1i, wx0, wx1 = _bilinear_axis(x1 + grid * bw / crop - 0.5,
                                       mask.shape[1])
    m = mask.astype(np.float64)
    rows = wy0[:, None] * m[y0] + wy1[:, None] * m[y1i]
    return (rows[:, x0] * wx0 + rows[:, x1i] * wx1).astype(np.float32)


def build_train_example(data: CocoData, iid, flip: bool, min_size=800,
                        max_size=1333, max_gt=64, crop=112):
    """One image -> (canvas, (h, w), padded targets), flipped if ``flip``."""
    img = data.load_image(iid)
    gt = data.load_target(iid)
    if flip:
        w = img.shape[1]
        img = np.ascontiguousarray(img[:, ::-1])
        b = gt["boxes"].copy()
        b[:, [0, 2]] = w - gt["boxes"][:, [2, 0]] - 1
        gt["boxes"] = b
        gt["masks"] = np.ascontiguousarray(gt["masks"][:, :, ::-1])
    canvas, (th, tw), (sy, sx) = preprocess_image_bgr(
        img[:, :, ::-1], min_size, max_size)
    g = min(len(gt["boxes"]), max_gt)
    boxes = np.zeros((max_gt, 4), np.float32)
    classes = np.full((max_gt,), -1, np.int32)
    crops = np.zeros((max_gt, crop, crop), np.float32)
    for i in range(g):
        if gt["iscrowd"][i]:
            continue
        boxes[i] = gt["boxes"][i] * np.asarray([sx, sy, sx, sy], np.float32)
        classes[i] = gt["classes"][i]
        crops[i] = crop_mask(gt["masks"][i], gt["boxes"][i], crop) > 0.5
    return canvas, (th, tw), {
        "boxes": boxes, "classes": classes, "mask_crops": crops}


def batch_to_device(examples, dev) -> tuple:
    imgs, hws, tgts = zip(*examples)
    images = torch.from_numpy(np.stack(imgs).transpose(0, 3, 1, 2).copy())
    targets = {k: torch.from_numpy(np.stack([t[k] for t in tgts])).to(dev)
               for k in tgts[0]}
    return (images.to(dev), torch.tensor(hws, dtype=torch.int64, device=dev),
            targets)
