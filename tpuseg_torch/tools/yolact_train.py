"""YOLACT / YOLACT++ training on the PyTorch port (Yolact.jittor train.py
CLI parity; the port's copy of ``tools/yolact_train.py``).

    python -m tpuseg_torch.tools.yolact_train --config=yolact_base_config \
        --batch_size=8 [--train_images=dir --train_info=instances.json] \
        [--device=cpu]
    python -m tpuseg_torch.tools.yolact_train --config=yolact_base_config \
        --resume=weights/yolact_base_10_32100.pth --start_iter=-1

Without --resume the model starts from random weights (seed 0).
Checkpoints are upstream's ``<config>_<epoch>_<iter>.pth``, or with
``--save_format npz`` the JAX package's param tree
``<config>_<epoch>_<iter>.npz``. ``--compute_dtype bfloat16`` trains in
mixed precision (f32 master weights).
"""
import argparse


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="yolact_base_config")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--start_iter", type=int, default=-1)
    ap.add_argument("--save_folder", default="weights/")
    ap.add_argument("--save_interval", type=int, default=10000)
    ap.add_argument("--save_format", default="pth", choices=["pth", "npz"],
                    help="pth = reference SavePath convention (torch-zip, "
                         "loads in upstream yolact); npz = the JAX "
                         "package's param tree")
    ap.add_argument("--max_iter", type=int, default=800000)
    ap.add_argument("--max_steps", type=int, default=None,
                    help="stop after N steps (smoke runs)")
    ap.add_argument("--train_images", default=None)
    ap.add_argument("--train_info", default=None)
    ap.add_argument("--compute_dtype", default=None,
                    choices=[None, "bfloat16"],
                    help="bfloat16 = mixed precision (f32 master weights)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from tpuseg_torch.configs.presets import (DATASETS, PRESETS,
                                              yolact_loss_config,
                                              yolact_model_config)
    from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
    from tpuseg_torch.engine.yolact_train_loop import train

    preset = PRESETS[args.config.removesuffix("_config")]
    ds_cfg = DATASETS[preset["dataset"]]
    dataset = CocoDetectionDataset(
        args.train_images or ds_cfg["train_images"],
        args.train_info or ds_cfg["train_info"])
    print(f"config: {args.config}  dataset: {len(dataset)} images  "
          f"batch: {args.batch_size}")
    _, it, history = train(
        dataset, yolact_model_config(preset), batch_size=args.batch_size,
        max_iter=args.max_iter, save_every=args.save_interval,
        save_folder=args.save_folder, cfg_name=preset["name"],
        resume=args.resume, start_iter=args.start_iter,
        max_steps=args.max_steps, loss_cfg=yolact_loss_config(preset),
        device=args.device, save_format=args.save_format,
        compute_dtype=(torch.bfloat16 if args.compute_dtype == "bfloat16"
                       else None))
    if history:
        print(f"{it} iterations; last losses: " + " | ".join(
            f"{k}: {v:.3f}" for k, v in history[-1].items()), flush=True)
    return history


if __name__ == "__main__":
    main()
