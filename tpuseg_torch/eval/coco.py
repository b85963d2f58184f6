"""COCO annotation container: pycocotools.coco.COCO's API surface, numpy
only (the port's copy of ``tpuseg/eval/coco.py``).

The reference's data/eval layers program against pycocotools' COCO class
(detectron COCODataset, yolact COCODetection, Pose2Seg CocoDatasetInfo).
This is a from-scratch reimplementation of the subset they use, backed by
our RLE codec (tpuseg_torch.eval.rle).
"""
from __future__ import annotations

import copy
import json
from collections import defaultdict

import numpy as np

from tpuseg_torch.eval import rle as rle_mod


class COCO:
    def __init__(self, annotation_file: str | dict | None = None):
        self.dataset = {}
        self.anns = {}
        self.imgs = {}
        self.cats = {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, str):
                with open(annotation_file) as f:
                    dataset = json.load(f)
            else:
                dataset = annotation_file
            assert isinstance(dataset, dict)
            self.dataset = dataset
            self.createIndex()

    def createIndex(self):
        anns, cats, imgs = {}, {}, {}
        imgToAnns = defaultdict(list)
        catToImgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            if "category_id" in ann:
                catToImgs[ann["category_id"]].append(ann["image_id"])
        self.anns = anns
        self.imgs = imgs
        self.cats = cats
        self.imgToAnns = imgToAnns
        self.catToImgs = catToImgs

    # -- query API ----------------------------------------------------------
    def getAnnIds(self, imgIds=[], catIds=[], areaRng=[], iscrowd=None):
        imgIds = imgIds if isinstance(imgIds, (list, tuple)) else [imgIds]
        catIds = catIds if isinstance(catIds, (list, tuple)) else [catIds]
        if len(imgIds) == len(catIds) == len(areaRng) == 0:
            anns = self.dataset.get("annotations", [])
        else:
            if len(imgIds) > 0:
                anns = [a for i in imgIds for a in self.imgToAnns[i]]
            else:
                anns = self.dataset.get("annotations", [])
            if len(catIds) > 0:
                cset = set(catIds)
                anns = [a for a in anns if a["category_id"] in cset]
            if len(areaRng) > 0:
                anns = [
                    a for a in anns
                    if areaRng[0] < a["area"] < areaRng[1]
                ]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=[], supNms=[], catIds=[]):
        cats = self.dataset.get("categories", [])
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getImgIds(self, imgIds=[], catIds=[]):
        imgIds = imgIds if isinstance(imgIds, (list, tuple)) else [imgIds]
        catIds = catIds if isinstance(catIds, (list, tuple)) else [catIds]
        if len(imgIds) == len(catIds) == 0:
            ids = set(self.imgs.keys())
        else:
            # pycocotools semantics: seed with imgIds; the first catId seeds
            # the set only when imgIds was empty, later catIds intersect
            ids = set(imgIds)
            for i, catId in enumerate(catIds):
                s = set(self.catToImgs[catId])
                if i == 0 and len(ids) == 0:
                    ids = s
                else:
                    ids &= s
        return sorted(ids)

    def loadAnns(self, ids=[]):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.anns[i] for i in ids]

    def loadCats(self, ids=[]):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.cats[i] for i in ids]

    def loadImgs(self, ids=[]):
        ids = ids if isinstance(ids, (list, tuple)) else [ids]
        return [self.imgs[i] for i in ids]

    # -- results ------------------------------------------------------------
    def loadRes(self, resFile) -> "COCO":
        """Detection results (list of dicts or json path) -> result COCO."""
        res = COCO()
        res.dataset = {"images": [img for img in self.dataset.get("images", [])]}
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = copy.deepcopy(resFile)
        assert isinstance(anns, list), "results must be a list"
        if len(anns) == 0:
            res.dataset["annotations"] = []
            res.dataset["categories"] = copy.deepcopy(
                self.dataset.get("categories", [])
            )
            res.createIndex()
            return res
        # branch precedence and unconditional area/iscrowd overwrite match
        # pycocotools loadRes exactly: results carrying BOTH bbox and
        # segmentation take the bbox branch only (area = w*h, not the mask
        # area — areaRng matching in evaluateImg is sensitive to this)
        if "bbox" in anns[0] and anns[0]["bbox"] != []:
            for aid, ann in enumerate(anns):
                bb = ann["bbox"]
                x1, x2 = bb[0], bb[0] + bb[2]
                y1, y2 = bb[1], bb[1] + bb[3]
                if "segmentation" not in ann:
                    ann["segmentation"] = [[x1, y1, x1, y2, x2, y2, x2, y1]]
                ann["area"] = bb[2] * bb[3]
                ann["id"] = aid + 1
                ann["iscrowd"] = 0
        elif "segmentation" in anns[0] and isinstance(
                anns[0]["segmentation"], dict):
            for aid, ann in enumerate(anns):
                ann["area"] = rle_mod.area(ann["segmentation"])
                if "bbox" not in ann:
                    m = rle_mod.decode(ann["segmentation"])
                    ys, xs = np.nonzero(m)
                    if len(xs):
                        ann["bbox"] = [
                            float(xs.min()), float(ys.min()),
                            float(xs.max() - xs.min() + 1),
                            float(ys.max() - ys.min() + 1),
                        ]
                    else:
                        ann["bbox"] = [0.0, 0.0, 0.0, 0.0]
                ann["id"] = aid + 1
                ann["iscrowd"] = 0
        res.dataset["annotations"] = anns
        res.dataset["categories"] = copy.deepcopy(self.dataset.get("categories", []))
        res.createIndex()
        return res

    # -- masks ----------------------------------------------------------------
    def annToRLE(self, ann) -> dict:
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        return rle_mod.segm_to_rle(ann["segmentation"], h, w)

    def annToMask(self, ann) -> np.ndarray:
        return rle_mod.decode(self.annToRLE(ann))
