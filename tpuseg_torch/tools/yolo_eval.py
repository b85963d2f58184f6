"""YOLOv3 COCO evaluation on the PyTorch port (yolo.jittor test.py; the
port's copy of ``tools/yolo_eval.py``).

    python -m tpuseg_torch.tools.yolo_eval --weights=yolov3.weights \
        --images=data/coco/val2017 \
        --annotations=data/coco/annotations/instances_val2017.json \
        [--batch_size=8] [--max_images=N] [--device=cuda]

Prints COCOeval's bbox table; ``main`` returns its 12 stats.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--images", required=True)
    ap.add_argument("--annotations", required=True)
    ap.add_argument("--img_size", type=int, default=416)
    ap.add_argument("--conf_thres", type=float, default=0.005)
    ap.add_argument("--nms_thres", type=float, default=0.45)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--max_images", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
    from tpuseg_torch.engine.yolo_engine import (YoloPredictor,
                                                 evaluate_coco_boxes)
    from tpuseg_torch.models.yolov3 import YoloV3Config

    cfg = YoloV3Config(input_size=args.img_size, conf_thresh=args.conf_thres,
                       nms_thresh=args.nms_thres)
    predictor = YoloPredictor(cfg, weights=args.weights,
                              batch_size=args.batch_size, device=args.device)
    dataset = CocoDetectionDataset(args.images, args.annotations)
    return evaluate_coco_boxes(predictor, dataset, max_images=args.max_images)


if __name__ == "__main__":
    main()
