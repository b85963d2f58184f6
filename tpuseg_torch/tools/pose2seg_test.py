"""Pose2Seg evaluation on the PyTorch port (Pose2Seg.jittor test.py CLI
parity; the port's copy of ``tools/pose2seg_test.py``): COCOeval on segm
with the ground-truth keypoints as the pose input.

    python -m tpuseg_torch.tools.pose2seg_test --weights last.pkl --coco \
        --coco_images <val2017 dir> --coco_ann <person_keypoints json>
    python -m tpuseg_torch.tools.pose2seg_test --weights last.pkl \
        --OCHuman --ochuman_images <dir> --ochuman_val <json> \
        [--ochuman_test <json>] [--device cpu]

Without --weights the model has random weights (seed 0).
"""
import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--coco", action="store_true")
    ap.add_argument("--OCHuman", action="store_true")
    ap.add_argument("--coco_images", default="./data/coco2017/val2017")
    ap.add_argument("--coco_ann",
                    default="./data/coco2017/annotations/"
                            "person_keypoints_val2017_pose2seg.json")
    ap.add_argument("--ochuman_images", default="./data/OCHuman/images")
    ap.add_argument("--ochuman_val",
                    default="./data/OCHuman/ochuman_coco_format_val_"
                            "range_0.00_1.00.json")
    ap.add_argument("--ochuman_test",
                    default="./data/OCHuman/ochuman_coco_format_test_"
                            "range_0.00_1.00.json")
    ap.add_argument("--max_images", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
    from tpuseg_torch.engine.pose2seg_engine import (Pose2SegPredictor,
                                                     evaluate_pose2seg)

    predictor = Pose2SegPredictor(weights=args.weights, device=args.device)
    runs = []
    if args.coco:
        runs.append(("cocoVal", args.coco_images, args.coco_ann))
    if args.OCHuman:
        runs.append(("OCHumanVal", args.ochuman_images, args.ochuman_val))
        runs.append(("OCHumanTest", args.ochuman_images, args.ochuman_test))
    stats = {}
    for name, images, ann in runs:
        print(f"===== {name} =====")
        ds = CocoDetectionDataset(images, ann, label_map=None)
        stats[name] = evaluate_pose2seg(predictor, ds,
                                        max_images=args.max_images)
    return stats


if __name__ == "__main__":
    main()
