"""Detectron COCO evaluation on the PyTorch port (detectron.jittor
tools/test_net.py parity; the port's copy of ``tools/test_net.py``): the
yaml picks Mask R-CNN or Faster R-CNN over FPN or C4, or RetinaNet.

    python -m tpuseg_torch.tools.test_net \
        --config-file configs/e2e_mask_rcnn_R_50_FPN_1x.yaml \
        --images datasets/coco/val2017 \
        --annotations datasets/coco/annotations/instances_val2017.json \
        MODEL.WEIGHT weights/e2e_mask_rcnn_R_50_FPN_1x.pth [--device=cpu] \
        [--devices all]

Without MODEL.WEIGHT the model has random weights (seed 0). Prints the
bbox COCOeval table, and the segm one for the models with a mask head.
"""
import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config-file", default=None)
    ap.add_argument("--images", default=None, help="COCO val image dir")
    ap.add_argument("--annotations", default=None, help="instances json")
    ap.add_argument("--max_images", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--devices", default=None,
                    help="'all' or N: shard each batch across that many "
                         "devices of --device's type (one replica each)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="dotted config overrides, e.g. MODEL.WEIGHT path")
    args = ap.parse_args(argv)

    from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
    from tpuseg_torch.engine.config import ConfigNode
    from tpuseg_torch.engine.maskrcnn_engine import (build_predictor_from_cfg,
                                                     evaluate_coco)

    cfg = ConfigNode({"MODEL": {"WEIGHT": ""},
                      "INPUT": {"MIN_SIZE_TEST": 800},
                      "DATASETS": {"IMAGES": args.images or "",
                                   "ANNOTATIONS": args.annotations or ""}})
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)

    predictor = build_predictor_from_cfg(cfg, device=args.device,
                                         devices=args.devices)
    dataset = CocoDetectionDataset(
        cfg.DATASETS.IMAGES, cfg.DATASETS.ANNOTATIONS, label_map=None)
    return evaluate_coco(predictor, dataset, max_images=args.max_images,
                         batch_size=args.batch_size)


if __name__ == "__main__":
    main()
