"""YOLACT / YOLACT++ evaluation and inference on the PyTorch port
(Yolact.jittor eval.py CLI parity; the port's copy of
``tools/yolact_eval.py``).

    # the COCO val mAP table (and with --output_coco_json, the two COCO
    # result jsons under results/ and their COCOeval)
    python -m tpuseg_torch.tools.yolact_eval \
        --trained_model=weights/yolact_plus_resnet50_54_800000.pth \
        [--valid_images=dir --valid_info=instances.json] [--device=cpu] \
        [--devices all]
    # one image, or a folder
    python -m tpuseg_torch.tools.yolact_eval --trained_model=... \
        --image=input.jpg:output.jpg
    python -m tpuseg_torch.tools.yolact_eval --trained_model=... \
        --images=in_dir:out_dir

The config comes from the weight file's name unless --config names it;
without --trained_model the model has random weights (seed 0).
"""
import argparse
import os


def infer_config_name(weights_path: str | None, explicit: str | None):
    """eval.py behavior: parse the config from the weight filename."""
    if explicit:
        return explicit
    if weights_path:
        base = os.path.basename(weights_path)
        # longest-prefix first so yolact_plus_* doesn't fall into
        # yolact_base
        for name in ("yolact_plus_resnet50", "yolact_plus_base",
                     "yolact_resnet50", "yolact_darknet53", "yolact_im700",
                     "yolact_im400", "yolact_base"):
            if base.startswith(name):
                return name + "_config"
    return "yolact_base_config"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trained_model", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--score_threshold", type=float, default=0.0)
    ap.add_argument("--top_k", type=int, default=5)
    ap.add_argument("--image", default=None, help="in.jpg or in.jpg:out.jpg")
    ap.add_argument("--images", default=None, help="in_dir:out_dir")
    ap.add_argument("--valid_images", default=None)
    ap.add_argument("--valid_info", default=None)
    ap.add_argument("--max_images", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--output_coco_json", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="run the model in bfloat16")
    ap.add_argument("--prior_topk", type=int, default=0,
                    help="two-stage candidate selection: compact the top-N "
                         "priors by max class score before per-class NMS "
                         "(0 = off/reference-exact)")
    ap.add_argument("--devices", default=None,
                    help="'all' or N: shard each batch across that many "
                         "devices of --device's type (one replica each)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from tpuseg_torch.configs.presets import (DATASETS, PRESETS,
                                              yolact_model_config)
    from tpuseg_torch.engine.yolact_engine import (YolactPredictor,
                                                   evaluate_dataset)

    cfg_name = infer_config_name(args.trained_model, args.config)
    preset = PRESETS[cfg_name.removesuffix("_config")]
    mcfg = yolact_model_config(preset)
    if args.prior_topk:
        mcfg = dataclasses.replace(mcfg, prior_topk=args.prior_topk)
    bs = 1 if (args.image or args.images) else args.batch_size
    predictor = YolactPredictor(
        mcfg, weights=args.trained_model, batch_size=bs,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=args.device, devices=args.devices)
    print(f"config: {cfg_name}  backbone: {mcfg.backbone}  "
          f"weights: {args.trained_model or '(random init)'}")

    def run_one(in_path, out_path):
        from tpuseg_torch.data.image_io import (draw_detections,
                                                load_image_rgb,
                                                save_image_bgr)

        img = load_image_rgb(in_path)
        final = predictor.predict_images(
            [img], max(args.score_threshold, 0.05))[0]
        order = np.argsort(-final["scores"], kind="stable")[: args.top_k]
        print(f"{in_path}: {len(order)} detections")
        for i in order:
            print(f"  class {int(final['classes'][i]):3d} "
                  f"score {final['scores'][i]:.3f}")
        if out_path:
            vis = draw_detections(
                np.ascontiguousarray(img[:, :, ::-1]), final["boxes"][order],
                final["masks"][order],
                [f"{int(final['classes'][i])}:{final['scores'][i]:.2f}"
                 for i in order], alpha=0.45)
            save_image_bgr(out_path, vis)
            print(f"wrote {out_path}")

    if args.image:
        parts = args.image.split(":")
        run_one(parts[0], parts[1] if len(parts) > 1 else None)
        return None
    if args.images:
        din, dout = args.images.split(":")
        os.makedirs(dout, exist_ok=True)
        for name in sorted(os.listdir(din)):
            if name.lower().endswith((".jpg", ".jpeg", ".png")):
                run_one(os.path.join(din, name), os.path.join(dout, name))
        return None

    # full dataset mAP
    from tpuseg_torch.data.coco_dataset import CocoDetectionDataset

    ds_cfg = DATASETS[preset["dataset"]]
    dataset = CocoDetectionDataset(
        args.valid_images or ds_cfg["valid_images"],
        args.valid_info or ds_cfg["valid_info"])
    return evaluate_dataset(predictor, dataset, max_images=args.max_images,
                            score_threshold=args.score_threshold,
                            output_coco_json=("results/yolact"
                                              if args.output_coco_json
                                              else None))


if __name__ == "__main__":
    main()
