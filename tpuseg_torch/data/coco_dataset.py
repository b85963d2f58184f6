"""COCO-format detection datasets (the port's copy of
``tpuseg/data/coco_dataset.py``).

Mirrors the data conventions of the reference zoo: COCO JSON
annotations + image dir; YOLACT's 91->81 contiguous label remap
(data/config.py COCO_LABEL_MAP); per-image gt boxes and polygon masks.
Backed by the port's pycocotools-free COCO container
(tpuseg_torch.eval.coco).
"""
from __future__ import annotations

import os

import numpy as np

from tpuseg_torch.data.image_io import load_image_rgb
from tpuseg_torch.eval import rle as rle_mod
from tpuseg_torch.eval.coco import COCO

# yolact data/config.py COCO_LABEL_MAP: category id -> contiguous 1..80
COCO_LABEL_MAP = {
    1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 7, 8: 8, 9: 9, 10: 10,
    11: 11, 13: 12, 14: 13, 15: 14, 16: 15, 17: 16, 18: 17, 19: 18,
    20: 19, 21: 20, 22: 21, 23: 22, 24: 23, 25: 24, 27: 25, 28: 26,
    31: 27, 32: 28, 33: 29, 34: 30, 35: 31, 36: 32, 37: 33, 38: 34,
    39: 35, 40: 36, 41: 37, 42: 38, 43: 39, 44: 40, 46: 41, 47: 42,
    48: 43, 49: 44, 50: 45, 51: 46, 52: 47, 53: 48, 54: 49, 55: 50,
    56: 51, 57: 52, 58: 53, 59: 54, 60: 55, 61: 56, 62: 57, 63: 58,
    64: 59, 65: 60, 67: 61, 70: 62, 72: 63, 73: 64, 74: 65, 75: 66,
    76: 67, 77: 68, 78: 69, 79: 70, 80: 71, 81: 72, 82: 73, 84: 74,
    85: 75, 86: 76, 87: 77, 88: 78, 89: 79, 90: 80,
}
COCO_CLASSES = 80


class CocoDetectionDataset:
    """Images + per-image targets (Yolact COCODetection / detectron
    COCODataset capability)."""

    def __init__(self, image_dir: str, ann_file: str,
                 label_map: dict | None = COCO_LABEL_MAP,
                 include_crowd: bool = True):
        self.image_dir = image_dir
        self.coco = COCO(ann_file)
        self.label_map = label_map
        self.include_crowd = include_crowd
        self.image_ids = sorted(self.coco.imgs.keys())

    def __len__(self):
        return len(self.image_ids)

    def image_path(self, image_id: int) -> str:
        info = self.coco.imgs[image_id]
        return os.path.join(self.image_dir, info["file_name"])

    def load_image(self, image_id: int) -> np.ndarray:
        # annotation frame: gt polygons rasterize at the json dims, which
        # are the raw (EXIF-ignored) pixel dims
        return load_image_rgb(self.image_path(image_id),
                              ignore_orientation=True)

    def load_target(self, image_id: int, with_masks: bool = True) -> dict:
        """-> {boxes [N,4] xyxy px, classes [N] 0-based, masks [N,H,W] u8,
        iscrowd [N]}."""
        info = self.coco.imgs[image_id]
        h, w = info["height"], info["width"]
        anns = self.coco.imgToAnns[image_id]
        boxes, classes, masks, crowd = [], [], [], []
        for ann in anns:
            if ann.get("iscrowd", 0) and not self.include_crowd:
                continue
            x, y, bw, bh = ann["bbox"]
            boxes.append([x, y, x + bw, y + bh])
            cid = ann["category_id"]
            if self.label_map is not None:
                # fail loudly like upstream (KeyError): a silent .get(cid, 0)
                # turned unknown categories into class -1, which collides
                # with the padding/ignore label convention downstream
                cid = self.label_map[cid]
            classes.append(cid - 1)
            crowd.append(int(ann.get("iscrowd", 0)))
            if with_masks:
                masks.append(rle_mod.decode(
                    rle_mod.segm_to_rle(ann["segmentation"], h, w)))
        return {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "iscrowd": np.asarray(crowd, np.int32),
            "masks": (
                np.stack(masks) if masks else np.zeros((0, h, w), np.uint8)
            ),
            "height": h,
            "width": w,
        }
