#!/usr/bin/env python
"""One-command real-weights parity gate on the PyTorch port (the port's
copy of ``tools/parity_gate.py``; the docs/PARITY.md runbook, automated).

Given pretrained checkpoints + COCO/OCHuman data, runs every family's eval
on the port's engines (on the card unless ``--device`` says otherwise) and
prints a mAP-delta table against the expected numbers:

    python -m tpuseg_torch.tools.parity_gate --weights_dir weights/ \
        --coco_images data/coco/val2017 \
        --coco_ann data/coco/annotations/instances_val2017.json \
        --ochuman_images data/OCHuman/images \
        --ochuman_val data/OCHuman/ochuman_coco_format_val_range_0.00_1.00.json

A family whose weight file is absent under --weights_dir (Pose2Seg: or
that has no data) gets a SKIP row and the run goes on. A family that
raises gets a ``FAILED: <error>`` row, the table still prints, the verdict
reads FAIL and the process exits 1 (with --smoke too); otherwise it exits
0, whether the verdict is PASS or ATTENTION. ``--smoke`` exercises the
full plumbing on a generated synthetic dataset with random weights: every
eval path runs, deltas are meaningless.

Expected numbers: YOLACT from its model zoo table (test-dev 28.2; val2017
~28.0 per the upstream repo); Mask R-CNN FPN/C4 and RetinaNet from the
upstream maskrcnn-benchmark MODEL_ZOO (approx); YOLOv3 from the paper @608.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
from pathlib import Path

# runnable as `python tpuseg_torch/tools/parity_gate.py` without installing
# the package
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def fam(name, weight, expect, note="", tol=0.1):
    """``tol`` is the per-row |delta| budget for the PASS verdict: 0.1 pt
    for rows whose expected value is exact, looser for rows whose expected
    value is itself approximate (rounded MODEL_ZOO entries, val-vs-testdev
    variance, paper numbers) — a perfect-parity run must be able to PASS."""
    return {"name": name, "weight": weight, "expect": expect, "note": note,
            "tol": tol}


FAMILIES = [
    fam("yolact_r50_550", "yolact_resnet50_54_800000.pth",
        {"box": 30.2, "mask": 28.0},
        "zoo README.md:211 (test-dev 28.2); val2017 ~28.0", tol=0.5),
    fam("mask_rcnn_r50_fpn", "e2e_mask_rcnn_R_50_FPN_1x.pth",
        {"box": 37.8, "mask": 34.2}, "upstream MODEL_ZOO (approx)", tol=0.5),
    fam("mask_rcnn_r50_c4", "e2e_mask_rcnn_R_50_C4_1x.pth",
        {"box": 35.6, "mask": 31.5}, "upstream MODEL_ZOO (approx)", tol=0.5),
    fam("retinanet_r50", "retinanet_R-50-FPN_1x.pth",
        {"box": 36.3}, "upstream MODEL_ZOO (approx)", tol=0.5),
    fam("yolov3_608", "yolov3.weights",
        {"box": 33.0}, "paper @608 (AP50 57.9)", tol=1.0),
    fam("pose2seg", "last.pkl",
        {}, "expected pending arbitration vs released table"),
]


# ---------------------------------------------------------------------------
# family runners: -> measured {"box": pts, "mask": pts} (percent points).
# Weights: ``state_dict`` where the caller gives one (the tests' carried-over
# JAX params), else the file ``wpath`` in real mode, else the predictor's
# seeded random weights.
# ---------------------------------------------------------------------------


def _weights(wpath, smoke, state_dict):
    """The weight file a runner loads: none in smoke mode or when the
    caller gives a state dict."""
    return None if smoke or state_dict is not None else wpath


def run_yolact(wpath, args, smoke, state_dict=None):
    from tpuseg_torch.configs.presets import yolact_model_config
    from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
    from tpuseg_torch.engine.yolact_engine import (YolactPredictor,
                                                   evaluate_dataset)
    from tpuseg_torch.models import yolact as Y

    if smoke:
        cfg = Y.YolactConfig(img_size=128, num_classes=3, nms_top_k=16,
                             max_num_detections=10)
        ds = CocoDetectionDataset(args.coco_images, args.coco_ann,
                                  label_map={1: 1, 2: 2})
        pred = YolactPredictor(cfg, state_dict=state_dict, batch_size=2,
                               device=args.device)
    else:
        cfg = yolact_model_config("yolact_resnet50_config")
        ds = CocoDetectionDataset(args.coco_images, args.coco_ann)
        pred = YolactPredictor(cfg, state_dict=state_dict,
                               weights=_weights(wpath, smoke, state_dict),
                               batch_size=args.batch_size,
                               device=args.device)
    maps = evaluate_dataset(pred, ds, max_images=args.max_images,
                            progress=not smoke)
    return {"box": maps["box"]["all"], "mask": maps["mask"]["all"]}


def _run_detectron(wpath, args, smoke, variant, state_dict=None):
    from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
    from tpuseg_torch.engine.maskrcnn_engine import (VARIANTS,
                                                     MaskRCNNPredictor,
                                                     build_model,
                                                     evaluate_coco)

    cfg = None
    if smoke:
        if variant == "fpn":
            cfg = VARIANTS[variant][1](
                rpn_pre_nms_top_n=64, rpn_post_nms_top_n=64,
                fpn_post_nms_top_n=32, detections_per_img=8,
                pre_final_nms_topk=128, num_classes=5)
        elif variant == "c4":
            cfg = VARIANTS[variant][1](
                rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32,
                detections_per_img=8, pre_final_nms_topk=128, num_classes=5)
        else:
            cfg = VARIANTS[variant][1](num_classes=5, pre_nms_top_n=64,
                                       detections_per_img=8)
        sizes = dict(min_image_size=64, max_image_size=128)
    else:
        sizes = dict(min_image_size=800, max_image_size=1333)
    model = None
    if state_dict is not None:
        model = build_model(cfg or VARIANTS[variant][1]())
        model.load_state_dict(state_dict, strict=True)
    pred = MaskRCNNPredictor(cfg, weights=_weights(wpath, smoke, state_dict),
                             model=model, variant=variant,
                             confidence_threshold=0.05, device=args.device,
                             **sizes)
    ds = CocoDetectionDataset(args.coco_images, args.coco_ann,
                              label_map=None)
    stats = evaluate_coco(pred, ds, max_images=args.max_images,
                          progress=not smoke)
    out = {"box": stats["bbox"][0] * 100}
    if "segm" in stats:
        out["mask"] = stats["segm"][0] * 100
    return out


def run_maskrcnn_fpn(wpath, args, smoke, state_dict=None):
    return _run_detectron(wpath, args, smoke, "fpn", state_dict)


def run_maskrcnn_c4(wpath, args, smoke, state_dict=None):
    return _run_detectron(wpath, args, smoke, "c4", state_dict)


def run_retinanet(wpath, args, smoke, state_dict=None):
    return _run_detectron(wpath, args, smoke, "retinanet", state_dict)


def run_yolov3(wpath, args, smoke, state_dict=None):
    from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
    from tpuseg_torch.engine.yolo_engine import (YoloPredictor,
                                                 evaluate_coco_boxes)
    from tpuseg_torch.models import yolov3 as Y3

    cfg = Y3.YoloV3Config(input_size=128 if smoke else 608)
    pred = YoloPredictor(cfg, state_dict=state_dict,
                         weights=_weights(wpath, smoke, state_dict),
                         batch_size=2,
                         device=args.device)
    ds = CocoDetectionDataset(args.coco_images, args.coco_ann,
                              label_map=None)
    stats = evaluate_coco_boxes(pred, ds, max_images=args.max_images,
                                progress=not smoke)
    return {"box": stats[0] * 100}


def run_pose2seg(wpath, args, smoke, state_dict=None):
    from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
    from tpuseg_torch.engine.pose2seg_engine import (Pose2SegPredictor,
                                                     evaluate_pose2seg)

    images = args.ochuman_images or args.coco_images
    ann = args.ochuman_val or args.coco_ann
    if smoke:
        from tpuseg_torch.models.pose2seg import Pose2SegConfig

        pred = Pose2SegPredictor(cfg=Pose2SegConfig(input_size=128,
                                                    max_people=4),
                                 state_dict=state_dict, device=args.device)
    else:
        pred = Pose2SegPredictor(state_dict=state_dict,
                                 weights=_weights(wpath, smoke, state_dict),
                                 device=args.device)
    ds = CocoDetectionDataset(images, ann, label_map=None)
    stats = evaluate_pose2seg(pred, ds, max_images=args.max_images,
                              progress=not smoke)
    return {"mask": stats[0] * 100}


RUNNERS = {
    "yolact_r50_550": run_yolact,
    "mask_rcnn_r50_fpn": run_maskrcnn_fpn,
    "mask_rcnn_r50_c4": run_maskrcnn_c4,
    "retinanet_r50": run_retinanet,
    "yolov3_608": run_yolov3,
    "pose2seg": run_pose2seg,
}


# ---------------------------------------------------------------------------
# synthetic smoke dataset (2 images, 2 categories, boxes+polygons+keypoints)
# ---------------------------------------------------------------------------


def write_smoke_dataset(root):
    """tpuseg's smoke dataset: the same pixels and annotation json, the
    JPEGs written by PIL at OpenCV's default quality (95)."""
    import numpy as np
    from PIL import Image

    os.makedirs(f"{root}/images", exist_ok=True)
    h = w = 128
    images, anns = [], []
    boxes_per_img = [
        [(16, 16, 48, 48, 1), (64, 64, 56, 56, 2)],
        [(32, 8, 64, 64, 1)],
    ]
    for i, boxes in enumerate(boxes_per_img):
        img = np.full((h, w, 3), 30, np.uint8)
        for (x, y, bw, bh, cat) in boxes:
            # RGB: tpuseg paints (cat * 80, 120, 200) into a BGR array
            img[y:y + bh, x:x + bw] = (200, 120, cat * 80)
            kp = []
            for k in range(17):  # coarse person-ish keypoints inside the box
                kp += [float(x + (k % 4) * bw / 4 + 2),
                       float(y + (k // 4) * bh / 5 + 2), 2]
            anns.append({
                "id": len(anns) + 1, "image_id": i + 1, "category_id": cat,
                "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
                "segmentation": [[x, y, x, y + bh, x + bw, y + bh, x + bw, y]],
                "keypoints": kp, "num_keypoints": 17,
            })
        Image.fromarray(img).save(f"{root}/images/{i + 1:03d}.jpg",
                                  quality=95)
        images.append({"id": i + 1, "height": h, "width": w,
                       "file_name": f"{i + 1:03d}.jpg"})
    ann = {"images": images, "annotations": anns,
           "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}
    path = f"{root}/ann.json"
    with open(path, "w") as f:
        json.dump(ann, f)
    return f"{root}/images", path


def failed(rows) -> list:
    """The names of the rows whose family raised."""
    return [r[0] for r in rows if r[3].startswith("FAILED")]


def run_families(args) -> list:
    """Each family asked for -> its row (name, measured or None, expected,
    note, tol): SKIP without its weight file (Pose2Seg: or without data),
    FAILED with the error where its runner raised."""
    only = set(args.only.split(",")) if args.only else None
    rows = []
    for f in FAMILIES:
        name = f["name"]
        if only and name not in only:
            continue
        wpath = os.path.join(args.weights_dir, f["weight"])
        if not args.smoke and not os.path.exists(wpath):
            rows.append((name, None, f["expect"], "SKIP (no weights)",
                         f["tol"]))
            continue
        if name == "pose2seg" and not args.smoke and not args.ochuman_val \
                and not args.coco_ann:
            rows.append((name, None, f["expect"], "SKIP (no data)", f["tol"]))
            continue
        print(f"\n===== {name} =====", flush=True)
        try:
            measured = RUNNERS[name](wpath, args, args.smoke)
            rows.append((name, measured, f["expect"], f["note"], f["tol"]))
        except Exception as e:  # finishes the table; the verdict fails
            rows.append((name, None, f["expect"], f"FAILED: {e}", f["tol"]))
    return rows


def report(rows, smoke: bool) -> None:
    """The mAP-delta table and the verdict: FAIL if a family raised, else
    (real mode) ATTENTION or PASS by the rows' tolerances, or NO VERDICT
    if every family was skipped."""
    print("\n" + "=" * 74)
    print(f"{'family':<22}{'metric':<7}{'measured':>9}{'expected':>9}"
          f"{'delta':>8}  note")
    print("-" * 74)
    breaches, worst = [], 0.0
    for name, measured, expect, note, tol in rows:
        if measured is None:
            print(f"{name:<22}{'-':<7}{'-':>9}{'-':>9}{'-':>8}  {note}")
            continue
        for metric, val in measured.items():
            exp = expect.get(metric)
            if exp is None:
                print(f"{name:<22}{metric:<7}{val:>9.2f}{'-':>9}{'-':>8}"
                      f"  {note}")
            else:
                d = val - exp
                if not smoke:
                    worst = max(worst, abs(d))
                    if abs(d) > tol:
                        breaches.append(f"{name}.{metric} {d:+.2f} "
                                        f"(tol {tol})")
                print(f"{name:<22}{metric:<7}{val:>9.2f}{exp:>9.2f}"
                      f"{d:>+8.2f}  {note}")
    print("=" * 74)
    fails = failed(rows)
    if not smoke:
        verdict = ("FAIL" if fails else "ATTENTION" if breaches
                   else "PASS" if any(r[1] is not None for r in rows)
                   else "NO VERDICT (no family measured)")
        print(f"worst |delta| = {worst:.2f} pt -> {verdict} "
              "(per-row gate: |delta| <= row tolerance; approx-expected "
              "rows carry looser tolerances)")
        for b in breaches:
            print(f"  breach: {b}")
    else:
        print("smoke mode: plumbing exercised; deltas not meaningful")
    if fails:
        print(f"FAIL: {', '.join(fails)} raised (their rows above)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--weights_dir", default="weights")
    ap.add_argument("--coco_images", default=None)
    ap.add_argument("--coco_ann", default=None)
    ap.add_argument("--ochuman_images", default=None)
    ap.add_argument("--ochuman_val", default=None)
    ap.add_argument("--max_images", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--only", default=None,
                    help="comma-separated family names")
    ap.add_argument("--smoke", action="store_true",
                    help="synthetic data + random weights: plumbing check")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with (tempfile.TemporaryDirectory(prefix="parity_smoke_") if args.smoke
          else contextlib.nullcontext()) as tmp:
        if args.smoke:
            args.coco_images, args.coco_ann = write_smoke_dataset(tmp)
            args.ochuman_images = args.ochuman_val = None
            args.max_images = 2
        rows = run_families(args)
    report(rows, args.smoke)
    return rows


if __name__ == "__main__":
    sys.exit(1 if failed(main()) else 0)
