"""DatasetCatalog (detectron.jittor detectron/config/paths_catalog.py
parity; the port's copy of ``tpuseg/data/catalog.py``).

Maps dataset names -> image dir + annotation file under a DATA_DIR root
(README.md:140-170 documents the expected layout).
"""
from __future__ import annotations

import os


class DatasetCatalog:
    DATA_DIR = "datasets"
    DATASETS = {
        "coco_2014_train": {
            "img_dir": "coco/train2014",
            "ann_file": "coco/annotations/instances_train2014.json",
        },
        "coco_2014_val": {
            "img_dir": "coco/val2014",
            "ann_file": "coco/annotations/instances_val2014.json",
        },
        "coco_2014_minival": {
            "img_dir": "coco/val2014",
            "ann_file": "coco/annotations/instances_minival2014.json",
        },
        "coco_2014_valminusminival": {
            "img_dir": "coco/val2014",
            "ann_file": "coco/annotations/instances_valminusminival2014.json",
        },
        "coco_2017_train": {
            "img_dir": "coco/train2017",
            "ann_file": "coco/annotations/instances_train2017.json",
        },
        "coco_2017_val": {
            "img_dir": "coco/val2017",
            "ann_file": "coco/annotations/instances_val2017.json",
        },
        "keypoints_coco_2017_val_pose2seg": {
            "img_dir": "coco2017/val2017",
            "ann_file": "coco2017/annotations/"
                        "person_keypoints_val2017_pose2seg.json",
        },
        "ochuman_val": {
            "img_dir": "OCHuman/images",
            "ann_file": "OCHuman/ochuman_coco_format_val_range_0.00_1.00.json",
        },
        "ochuman_test": {
            "img_dir": "OCHuman/images",
            "ann_file": "OCHuman/ochuman_coco_format_test_range_0.00_1.00.json",
        },
    }

    @classmethod
    def get(cls, name: str) -> dict:
        if name not in cls.DATASETS:
            raise KeyError(
                f"unknown dataset '{name}'; available: {sorted(cls.DATASETS)}")
        attrs = cls.DATASETS[name]
        return {
            "factory": "COCODataset",
            "args": {
                "root": os.path.join(cls.DATA_DIR, attrs["img_dir"]),
                "ann_file": os.path.join(cls.DATA_DIR, attrs["ann_file"]),
            },
        }

    @classmethod
    def register(cls, name: str, img_dir: str, ann_file: str) -> None:
        cls.DATASETS[name] = {"img_dir": img_dir, "ann_file": ann_file}
