"""tpuseg_torch.eval, the port's copy of the COCO evaluation stack (RLE
codec, COCO container, COCOeval, YOLACT's mAP), against tpuseg.eval on the
same seeded inputs: every result equal, not close. Also tpuseg's own
COCOeval sanity cases (tests/test_cocoeval.py), run on the port."""
import copy

import numpy as np
import pytest

from tpuseg.eval import rle as J_R
from tpuseg.eval import yolact_map as J_YM
from tpuseg.eval.coco import COCO as J_COCO
from tpuseg.eval.cocoeval import COCOeval as J_COCOeval
from tpuseg_torch.eval import rle as R
from tpuseg_torch.eval import yolact_map as YM
from tpuseg_torch.eval.coco import COCO
from tpuseg_torch.eval.cocoeval import COCOeval

CATS = (1, 18, 90)  # category ids from COCO's 91-id space


def _polygon(rng, box):
    """A star-shaped polygon inside ``box`` (x, y, w, h), 5-12 vertices."""
    x, y, w, h = box
    k = int(rng.integers(5, 13))
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    rad = rng.uniform(0.7, 1.0, k)
    px = x + w / 2 + rad * np.cos(ang) * w / 2
    py = y + h / 2 + rad * np.sin(ang) * h / 2
    return np.stack([px, py], 1).reshape(-1).round(2).tolist()


def _box(rng, hw, side):
    h, w = hw
    bw, bh = (min(float(s), d - 2) for s, d in zip(rng.uniform(*side, 2),
                                                   (w, h)))
    return [float(rng.uniform(0, w - bw)), float(rng.uniform(0, h - bh)),
            bw, bh]


def synthetic_coco(seed=0, n_images=6):
    """(gt dataset dict, bbox results, segm results). Small, medium and
    large objects (COCO's 32^2 and 96^2 area ranges), a crowd region as an
    uncompressed RLE on most images, an image without gt, more than 100
    detections on one image (maxDets 100), jittered true positives and
    random false positives."""
    rng = np.random.default_rng(seed)
    images, anns, dets = [], [], []
    for i in range(1, n_images + 1):
        hw = (220, 260) if i % 2 else (260, 220)
        images.append({"id": i, "height": hw[0], "width": hw[1],
                       "file_name": f"{i:03d}.png"})
        n_gt = 0 if i == 3 else int(rng.integers(3, 8))
        for side in [(8, 28), (40, 90), (150, 210)] * 3:
            if n_gt == 0:
                break
            n_gt -= 1
            box = _box(rng, hw, side)
            poly = _polygon(rng, box)
            area = R.area(R.poly_to_rle(np.asarray(poly), *hw))
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": int(rng.choice(CATS)), "bbox": box,
                         "area": float(area), "iscrowd": 0,
                         "segmentation": [poly]})
        if i % 3 != 0:
            box = _box(rng, hw, (30, 60))
            m = np.zeros(hw, np.uint8)
            x, y, bw, bh = (int(v) for v in box)
            m[y:y + bh, x:x + bw] = 1
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": int(rng.choice(CATS)),
                         "bbox": [float(x), float(y), float(bw), float(bh)],
                         "area": float(m.sum()), "iscrowd": 1,
                         "segmentation": {"size": list(hw), "counts": [
                             int(c) for c in R.encode_counts(m)]}})
        gts = [a for a in anns if a["image_id"] == i]
        n_dt = 130 if i == 1 else int(rng.integers(5, 30))
        for d in range(n_dt):
            if gts and d < 2 * len(gts):
                g = gts[d % len(gts)]
                box = [v + rng.normal(0, 0.08 * s) for v, s in zip(
                    g["bbox"], g["bbox"][2:] * 2)]
                cat = g["category_id"] if rng.random() < 0.8 else int(
                    rng.choice(CATS))
            else:
                box, cat = _box(rng, hw, (6, 120)), int(rng.choice(CATS))
            x, y = max(box[0], 0.0), max(box[1], 0.0)
            bw = max(min(box[2], hw[1] - x - 1), 1.0)
            bh = max(min(box[3], hw[0] - y - 1), 1.0)
            m = np.zeros(hw, np.uint8)
            m[int(y):int(np.ceil(y + bh)), int(x):int(np.ceil(x + bw))] = 1
            dets.append({"image_id": i, "category_id": cat,
                         "bbox": [x, y, bw, bh],
                         "score": float(rng.uniform(0.05, 1.0)),
                         "segmentation": R.encode(m)})
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": c, "name": f"c{c}"} for c in CATS]}
    bbox_res = [{k: v for k, v in d.items() if k != "segmentation"}
                for d in dets]
    segm_res = [{k: v for k, v in d.items() if k != "bbox"} for d in dets]
    return gt, bbox_res, segm_res


def _cocoeval(coco_cls, eval_cls, gt, res, iou_type):
    g = coco_cls(copy.deepcopy(gt))
    E = eval_cls(g, g.loadRes(copy.deepcopy(res)), iou_type)
    E.evaluate()
    E.accumulate()
    E.summarize()
    return E


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_cocoeval_stats_equal_tpuseg(iou_type):
    gt, bbox_res, segm_res = synthetic_coco()
    res = bbox_res if iou_type == "bbox" else segm_res
    assert sum(d["image_id"] == 1 for d in res) > 100
    got = _cocoeval(COCO, COCOeval, gt, res, iou_type)
    want = _cocoeval(J_COCO, J_COCOeval, gt, res, iou_type)
    np.testing.assert_array_equal(got.stats, want.stats)
    for k in ("precision", "recall", "scores"):
        np.testing.assert_array_equal(got.eval[k], want.eval[k], err_msg=k)
    # every area range and a crowd took part
    assert (got.stats[3:6] >= 0).all() and (got.stats[9:12] >= 0).all()
    assert any(a["iscrowd"] for a in gt["annotations"])


def test_coco_container_indexes_equal_tpuseg():
    gt, bbox_res, _ = synthetic_coco(seed=1)
    got, want = COCO(copy.deepcopy(gt)), J_COCO(copy.deepcopy(gt))
    assert got.getImgIds() == want.getImgIds()
    assert got.getCatIds() == want.getCatIds()
    for c in CATS:
        assert got.getImgIds(catIds=[c]) == want.getImgIds(catIds=[c])
    for i in got.getImgIds():
        assert got.getAnnIds(imgIds=i) == want.getAnnIds(imgIds=i)
        assert got.getAnnIds(imgIds=i, iscrowd=0) == want.getAnnIds(
            imgIds=i, iscrowd=0)
    for ann in got.dataset["annotations"]:
        np.testing.assert_array_equal(got.annToMask(ann),
                                      want.annToMask(ann))
    r_got = got.loadRes(copy.deepcopy(bbox_res))
    r_want = want.loadRes(copy.deepcopy(bbox_res))
    assert r_got.dataset["annotations"] == r_want.dataset["annotations"]


def test_rle_codec_equals_tpuseg(rng):
    for h, w in ((1, 1), (7, 13), (64, 48), (120, 160)):
        for density in (0.0, 0.1, 0.5, 1.0):
            m = (rng.random((h, w)) < density).astype(np.uint8)
            counts = R.encode_counts(m)
            np.testing.assert_array_equal(counts, J_R.encode_counts(m))
            s = R.counts_to_string(counts)
            assert s == J_R.counts_to_string(counts)
            np.testing.assert_array_equal(R.string_to_counts(s),
                                          J_R.string_to_counts(s))
            enc = R.encode(m)
            assert enc == J_R.encode(m)
            np.testing.assert_array_equal(R.decode(enc), m)
            assert R.area(enc) == J_R.area(enc) == int(m.sum())
            uncompressed = {"size": [h, w], "counts": counts.tolist()}
            np.testing.assert_array_equal(R.decode(uncompressed), m)
            assert R.segm_to_rle(uncompressed, h, w) == J_R.segm_to_rle(
                uncompressed, h, w)


def test_poly_merge_and_iou_equal_tpuseg(rng):
    h, w = 90, 130
    polys = [_polygon(rng, _box(rng, (h, w), (5, 80))) for _ in range(12)]
    polys.append([-0.3, -0.3, 8.0, -0.2, 8.0, 8.0, -0.3, 8.0])  # negative
    rles = []
    for p in polys:
        got = R.poly_to_rle(np.asarray(p), h, w)
        assert got == J_R.poly_to_rle(np.asarray(p), h, w)
        rles.append(got)
    merged = R.segm_to_rle(polys[:4], h, w)
    assert merged == J_R.segm_to_rle(polys[:4], h, w)
    assert R.merge(rles[4:7]) == J_R.merge(rles[4:7])
    crowd = [0, 1, 0, 0, 1]
    np.testing.assert_array_equal(R.mask_iou(rles[:7], rles[7:12], crowd),
                                  J_R.mask_iou(rles[:7], rles[7:12], crowd))
    dt = rng.uniform(0, 60, (9, 4))
    gt = rng.uniform(0, 60, (5, 4))
    np.testing.assert_array_equal(R.box_iou(dt, gt, crowd),
                                  J_R.box_iou(dt, gt, crowd))
    assert R.mask_iou([], rles[:2], [0, 0]).shape == (0, 2)


def _yolact_image(rng, n_gt, n_det, n_cls, hw=(48, 64)):
    h, w = hw
    boxes = np.sort(rng.uniform(0, [w, h, w, h], (n_gt, 4)).reshape(
        n_gt, 2, 2), 1).reshape(n_gt, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    boxes = np.concatenate([np.minimum(boxes[:, :2], boxes[:, 2:]),
                            np.maximum(boxes[:, :2], boxes[:, 2:]) + 2], 1)
    masks = np.zeros((n_gt, h, w), np.uint8)
    for j, (x1, y1, x2, y2) in enumerate(boxes.astype(int)):
        masks[j, y1:y2, x1:x2] = 1
    gt = {"boxes": boxes, "classes": rng.integers(0, n_cls, n_gt),
          "masks": masks, "iscrowd": (rng.random(n_gt) < 0.2).astype(
              np.int32)}
    pick = rng.integers(0, n_gt, n_det)
    dboxes = boxes[pick] + rng.normal(0, 2, (n_det, 4)).astype(np.float32)
    dmasks = np.roll(masks[pick], int(rng.integers(-2, 3)), axis=2)
    classes = np.where(rng.random(n_det) < 0.8, gt["classes"][pick],
                       rng.integers(0, n_cls, n_det))
    det = {"boxes": dboxes, "scores": rng.uniform(0, 1, n_det).astype(
        np.float32), "classes": classes, "masks": dmasks,
           "mask_scores": rng.uniform(0, 1, n_det).astype(np.float32)}
    return det, gt


def test_yolact_calc_map_equals_tpuseg(rng):
    n_cls = 5
    got, want = YM.make_ap_data(n_cls), J_YM.make_ap_data(n_cls)
    for i in range(6):
        det, gt = _yolact_image(rng, int(rng.integers(1, 9)),
                                int(rng.integers(0, 25)), n_cls)
        if i == 0:
            del det["mask_scores"]  # YOLACT without rescoring
        YM.prep_metrics(got, det, gt)
        J_YM.prep_metrics(want, det, gt)
    maps = YM.calc_map(got, n_cls)
    assert maps == J_YM.calc_map(want, n_cls)
    assert 0 < maps["box"]["all"] < 100 and 0 < maps["mask"]["all"] < 100
    assert YM.print_maps(maps) == J_YM.print_maps(maps)


# tpuseg's COCOeval sanity cases (tests/test_cocoeval.py), on the port


def _make_gt(num_imgs=2):
    images = [{"id": i + 1, "height": 50, "width": 50}
              for i in range(num_imgs)]
    cats = [{"id": 1, "name": "thing"}, {"id": 2, "name": "stuff"}]
    anns = []

    def add(img_id, cat, box, crowd=0):
        x, y, w, h = box
        anns.append({
            "id": len(anns) + 1, "image_id": img_id, "category_id": cat,
            "bbox": [x, y, w, h], "area": w * h, "iscrowd": crowd,
            "segmentation": [[x, y, x, y + h, x + w, y + h, x + w, y]],
        })
    add(1, 1, [5, 5, 10, 10])
    add(1, 1, [30, 30, 12, 12])
    add(2, 1, [10, 10, 8, 8])
    add(2, 2, [20, 20, 15, 15])
    return {"images": images, "categories": cats, "annotations": anns}


def _dt(img_id, cat, box, score):
    return {"image_id": img_id, "category_id": cat, "bbox": list(box),
            "score": score}


def run_eval(gt_dict, dts, iou_type="bbox"):
    if iou_type == "segm":
        for d in dts:
            x, y, w, h = d.pop("bbox")
            m = np.zeros((50, 50), np.uint8)
            m[int(y):int(y + h), int(x):int(x + w)] = 1
            d["segmentation"] = R.encode(m)
    return _cocoeval(COCO, COCOeval, gt_dict, dts, iou_type).stats


PERFECT = [_dt(1, 1, [5, 5, 10, 10], 0.9), _dt(1, 1, [30, 30, 12, 12], 0.8),
           _dt(2, 1, [10, 10, 8, 8], 0.95), _dt(2, 2, [20, 20, 15, 15], 0.85)]


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_perfect_detections_ap1(iou_type):
    stats = run_eval(_make_gt(), copy.deepcopy(PERFECT), iou_type)
    assert stats[0] == pytest.approx(1.0)
    assert stats[1] == pytest.approx(1.0)


def test_half_recall_ap():
    stats = run_eval(_make_gt(), [copy.deepcopy(PERFECT[i])
                                  for i in (0, 2, 3)])
    # class 1: 2 of 3 gts at precision 1 -> 67 of 101 recall points
    assert stats[0] == pytest.approx((67 / 101 + 1.0) / 2, abs=1e-6)


def test_false_positive_lowers_precision():
    dts = copy.deepcopy(PERFECT) + [_dt(2, 2, [1, 1, 5, 5], 0.99)]
    assert run_eval(_make_gt(), dts)[0] == pytest.approx((1.0 + 0.5) / 2,
                                                         abs=1e-6)


def test_crowd_gt_is_ignored():
    gt_dict = _make_gt()
    x, y, w, h = 40, 5, 8, 8
    gt_dict["annotations"].append({
        "id": 99, "image_id": 1, "category_id": 1,
        "bbox": [x, y, w, h], "area": w * h, "iscrowd": 1,
        "segmentation": {"size": [50, 50], "counts": R.counts_to_string(
            R.encode_counts(np.ones((50, 50), np.uint8)))},
    })
    dts = copy.deepcopy(PERFECT) + [_dt(1, 1, [40, 5, 8, 8], 0.99)]
    assert run_eval(gt_dict, dts)[0] == pytest.approx(1.0)


def test_localization_quality_thresholds():
    gt = {"images": [{"id": 1, "height": 100, "width": 100}],
          "categories": [{"id": 1, "name": "x"}],
          "annotations": [{"id": 1, "image_id": 1, "category_id": 1,
                           "bbox": [10, 10, 20, 20], "area": 400,
                           "iscrowd": 0,
                           "segmentation": [[10, 10, 10, 30, 30, 30, 30,
                                             10]]}]}
    stats = run_eval(gt, [_dt(1, 1, [14, 10, 20, 20], 0.9)])  # IoU 0.667
    assert stats[0] == pytest.approx(0.4, abs=1e-6)
    assert stats[1] == pytest.approx(1.0)
