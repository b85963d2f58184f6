"""YOLACT's own mAP protocol (eval.py APDataObject / calc_map /
prep_metrics; the port's copy of ``tpuseg/eval/yolact_map.py``).

The reference's primary eval surface is its OWN mAP table (not COCOeval):
per (iou_type, iou_threshold, class) greedy matching with crowd-ignore,
101-point interpolated AP, printed as the box/mask table
[A: README.md:241-250]. Reimplemented here over numpy inputs.
"""
from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = [x / 100 for x in range(50, 100, 5)]


class APDataObject:
    def __init__(self):
        self.data_points: list[tuple[float, bool]] = []
        self.num_gt_positives = 0

    def push(self, score: float, is_true: bool):
        self.data_points.append((score, is_true))

    def add_gt_positives(self, num: int):
        self.num_gt_positives += num

    def is_empty(self) -> bool:
        return len(self.data_points) == 0 and self.num_gt_positives == 0

    def get_ap(self) -> float:
        if self.num_gt_positives == 0:
            return 0
        data = sorted(self.data_points, key=lambda x: -x[0])
        precisions = []
        recalls = []
        num_true = 0
        num_false = 0
        for datum in data:
            if datum[1]:
                num_true += 1
            else:
                num_false += 1
            precisions.append(num_true / (num_true + num_false))
            recalls.append(num_true / self.num_gt_positives)
        for i in range(len(precisions) - 1, 0, -1):
            if precisions[i] > precisions[i - 1]:
                precisions[i - 1] = precisions[i]
        y_range = [0.0] * 101
        x_range = np.asarray([x / 100 for x in range(101)])
        recalls = np.asarray(recalls)
        indices = recalls.searchsorted(x_range, side="left")
        for bar_idx, precision_idx in enumerate(indices):
            if precision_idx < len(precisions):
                y_range[bar_idx] = precisions[precision_idx]
        return sum(y_range) / len(y_range)


def make_ap_data(num_classes: int) -> dict:
    return {
        "box": [[APDataObject() for _ in range(num_classes)]
                for _ in IOU_THRESHOLDS],
        "mask": [[APDataObject() for _ in range(num_classes)]
                 for _ in IOU_THRESHOLDS],
    }


def _pairwise_box_iou(a: np.ndarray, b: np.ndarray, iscrowd=False) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    denom = area_a[:, None] if iscrowd else area_a[:, None] + area_b[None] - inter
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _pairwise_mask_iou(a: np.ndarray, b: np.ndarray, iscrowd=False) -> np.ndarray:
    """a [N,H,W] u8, b [M,H,W] u8."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    af = a.reshape(len(a), -1).astype(np.float32)
    bf = b.reshape(len(b), -1).astype(np.float32)
    inter = af @ bf.T
    area_a = af.sum(1)
    area_b = bf.sum(1)
    denom = area_a[:, None] if iscrowd else area_a[:, None] + area_b[None] - inter
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def prep_metrics(ap_data: dict, det: dict, gt: dict) -> None:
    """Accumulate one image (eval.py prep_metrics semantics).

    det: {boxes [D,4] xyxy px, scores [D], classes [D] 0-based,
          masks [D,H,W] u8[, mask_scores [D] for YOLACT++ rescoring]}
    gt:  {boxes, classes, masks, iscrowd} from CocoDetectionDataset.

    With ``mask_scores`` present, the mask iou_type sorts its greedy
    matching and pushes by the rescored values while box keeps the raw
    scores (eval.py: box_indices / mask_indices, score_func per type).
    """
    crowd_sel = gt["iscrowd"] > 0
    gt_boxes = gt["boxes"][~crowd_sel]
    gt_classes = gt["classes"][~crowd_sel].tolist()
    gt_masks = gt["masks"][~crowd_sel] if len(gt["masks"]) else gt["masks"]
    crowd_boxes = gt["boxes"][crowd_sel]
    crowd_classes = gt["classes"][crowd_sel].tolist()
    crowd_masks = gt["masks"][crowd_sel] if len(gt["masks"]) else gt["masks"]

    boxes = det["boxes"]
    classes = det["classes"].tolist()
    masks = det["masks"]
    box_scores = np.asarray(det["scores"])
    mask_scores = np.asarray(det.get("mask_scores", det["scores"]))
    num_pred = len(classes)
    box_order = np.argsort(-box_scores, kind="stable")
    # eval.py: mask_indices = sorted(box_indices, key=-mask_score) (stable)
    mask_order = box_order[np.argsort(-mask_scores[box_order],
                                      kind="stable")]

    box_iou = _pairwise_box_iou(boxes, gt_boxes)
    mask_iou = _pairwise_mask_iou(masks, gt_masks)
    crowd_box_iou = _pairwise_box_iou(boxes, crowd_boxes, iscrowd=True)
    crowd_mask_iou = _pairwise_mask_iou(masks, crowd_masks, iscrowd=True)

    iou_types = [
        ("box", box_iou, crowd_box_iou, box_scores, box_order),
        ("mask", mask_iou, crowd_mask_iou, mask_scores, mask_order),
    ]
    all_classes = set(classes + gt_classes)
    for _class in all_classes:
        num_gt_for_class = sum(1 for c in gt_classes if c == _class)
        for iouIdx, iou_threshold in enumerate(IOU_THRESHOLDS):
            for iou_type, iou_cache, crowd_cache, t_scores, order in \
                    iou_types:
                gt_used = [False] * len(gt_classes)
                ap_obj = ap_data[iou_type][iouIdx][_class]
                ap_obj.add_gt_positives(num_gt_for_class)
                for i in order:
                    if classes[i] != _class:
                        continue
                    max_iou_found = iou_threshold
                    max_match_idx = -1
                    for j in range(len(gt_classes)):
                        if gt_used[j] or gt_classes[j] != _class:
                            continue
                        iou = iou_cache[i, j]
                        if iou > max_iou_found:
                            max_iou_found = iou
                            max_match_idx = j
                    if max_match_idx >= 0:
                        gt_used[max_match_idx] = True
                        ap_obj.push(float(t_scores[i]), True)
                    else:
                        matched_crowd = False
                        for j in range(len(crowd_classes)):
                            if crowd_classes[j] != _class:
                                continue
                            if crowd_cache[i, j] > iou_threshold:
                                matched_crowd = True
                                break
                        if not matched_crowd:
                            ap_obj.push(float(t_scores[i]), False)


def calc_map(ap_data: dict, num_classes: int) -> dict:
    """-> {'box': {'all': %, 50: %, ...}, 'mask': {...}} (eval.py calc_map)."""
    aps = [{"box": [], "mask": []} for _ in IOU_THRESHOLDS]
    for _class in range(num_classes):
        for iou_idx in range(len(IOU_THRESHOLDS)):
            for iou_type in ("box", "mask"):
                ap_obj = ap_data[iou_type][iou_idx][_class]
                if not ap_obj.is_empty():
                    aps[iou_idx][iou_type].append(ap_obj.get_ap())
    all_maps = {"box": {}, "mask": {}}
    for iou_type in ("box", "mask"):
        all_maps[iou_type]["all"] = 0
        for i, threshold in enumerate(IOU_THRESHOLDS):
            mAP = (
                sum(aps[i][iou_type]) / len(aps[i][iou_type]) * 100
                if len(aps[i][iou_type]) > 0
                else 0
            )
            all_maps[iou_type][int(threshold * 100)] = mAP
        vals = [v for k, v in all_maps[iou_type].items() if k != "all"]
        all_maps[iou_type]["all"] = sum(vals) / len(vals)
    return all_maps


def print_maps(all_maps: dict) -> str:
    """The reference's table format (eval.py print_maps)."""

    def make_row(vals):
        return (" %5s |" * len(vals)) % tuple(vals)

    def make_sep(n):
        return ("-------+" * n)

    lines = []
    keys = list(all_maps["box"].keys())
    lines.append(make_row([""] + [(".%d " % x if isinstance(x, int) else x + " ")
                                  for x in keys]))
    lines.append(make_sep(len(keys) + 1))
    for iou_type in ("box", "mask"):
        lines.append(make_row(
            [iou_type] + ["%.2f" % x if x < 100 else "%.1f" % x
                          for x in all_maps[iou_type].values()]))
    lines.append(make_sep(len(keys) + 1))
    out = "\n".join(lines)
    print(out)
    return out
