"""Detectron training on the PyTorch port (detectron.jittor
tools/train_net.py parity; the port's copy of ``tools/train_net.py``): the
yaml picks Mask R-CNN or Faster R-CNN over FPN or C4, or RetinaNet.

    python -m tpuseg_torch.tools.train_net \
        --config-file configs/e2e_mask_rcnn_R_50_FPN_1x.yaml \
        [SOLVER.IMS_PER_BATCH 8] [DATASETS.IMAGES dir DATASETS.ANNOTATIONS json]
        [MODEL.WEIGHT init.pth] [--max_steps N] [--compute_dtype bfloat16]
        [--device=cpu]

Without DATASETS.IMAGES the images and annotations come from
DATASETS.TRAIN through the DatasetCatalog; without MODEL.WEIGHT the model
starts from random weights (seed 0). INPUT.MIN_SIZE_TRAIN and
INPUT.MAX_SIZE_TRAIN set the training canvas (800 and 1333).
``--compute_dtype bfloat16`` trains in mixed precision: a bf16 forward and
backward, the f32 master weights in the optimizer. Checkpoints go to
OUTPUT_DIR as ``model_<iter>.pth`` and ``model_<iter>.npz``.
"""
import argparse


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config-file", default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--compute_dtype", default=None,
                    choices=[None, "bfloat16"],
                    help="bfloat16 = mixed precision (f32 master weights)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    import torch

    from tpuseg_torch.data.coco_dataset import (COCO_LABEL_MAP,
                                                CocoDetectionDataset)
    from tpuseg_torch.engine.config import ConfigNode
    from tpuseg_torch.engine.detectron_train_loop import do_train
    from tpuseg_torch.engine.maskrcnn_engine import (build_model,
                                                     model_config_from_node)

    cfg = ConfigNode({
        "MODEL": {"WEIGHT": "", "MASK_ON": True},
        "SOLVER": {"BASE_LR": 0.0025, "WEIGHT_DECAY": 0.0001,
                   "STEPS": [120000, 160000], "MAX_ITER": 180000,
                   "IMS_PER_BATCH": 2, "CHECKPOINT_PERIOD": 2500},
        "INPUT": {"MIN_SIZE_TRAIN": 800, "MAX_SIZE_TRAIN": 1333},
        "DATASETS": {"TRAIN": "coco_2017_train", "IMAGES": "",
                     "ANNOTATIONS": ""},
        "OUTPUT_DIR": "weights/detectron",
    })
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    if cfg.DATASETS.IMAGES:
        images, ann = cfg.DATASETS.IMAGES, cfg.DATASETS.ANNOTATIONS
    else:
        from tpuseg_torch.data.catalog import DatasetCatalog

        d = DatasetCatalog.get(cfg.DATASETS.TRAIN)["args"]
        images, ann = d["root"], d["ann_file"]
    # contiguous 0..79 labels (COCO_LABEL_MAP then -1): the 81-way heads
    # and eval's COCO_CATEGORY_IDS assume this
    dataset = CocoDetectionDataset(images, ann, label_map=COCO_LABEL_MAP)
    print(f"training on {len(dataset)} images; "
          f"max_iter {cfg.SOLVER.MAX_ITER}")
    # the yaml's model: its variant, depth, MASK_ON and NUM_CLASSES
    _, mcfg = model_config_from_node(cfg)
    model = None
    if cfg.MODEL.WEIGHT:
        from tpuseg_torch.weights.detectron_map import load_detectron_weights

        model = load_detectron_weights(cfg.MODEL.WEIGHT, build_model(mcfg))
    _, it, history = do_train(
        dataset, mcfg, model=model, base_lr=cfg.SOLVER.BASE_LR,
        steps=tuple(cfg.SOLVER.STEPS), max_iter=cfg.SOLVER.MAX_ITER,
        ims_per_batch=cfg.SOLVER.IMS_PER_BATCH,
        checkpoint_period=cfg.SOLVER.CHECKPOINT_PERIOD,
        output_dir=cfg.OUTPUT_DIR, max_steps=args.max_steps,
        device=args.device, min_size=int(cfg.INPUT.MIN_SIZE_TRAIN),
        max_size=int(cfg.INPUT.MAX_SIZE_TRAIN),
        compute_dtype=(torch.bfloat16 if args.compute_dtype == "bfloat16"
                       else None))
    if history:
        print(f"{it} iterations; last losses: " + "  ".join(
            f"{k}: {v:.4f}" for k, v in history[-1].items()), flush=True)
    return history


if __name__ == "__main__":
    main()
