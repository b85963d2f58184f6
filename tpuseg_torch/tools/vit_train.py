"""ViT finetuning on the PyTorch port (ViT.jittor train.py; the port's
copy of ``tools/vit_train.py``).

    python -m tpuseg_torch.tools.vit_train [--config vit_b16_config] \
        [--data_dir <root with one folder of images per class>] \
        [--weights vit.pth|vit.npz] [--batch_size 32] [--steps 1000] \
        [--lr 3e-2] [--save weights/vit_finetuned.npz] [--device cuda]

With ``--data_dir`` each step draws ``--batch_size`` images at random
(numpy, seed 0) and decodes them at the model's size
(``data/native_loader.py``); without it the images and labels are random
(a smoke run). The params are saved as the JAX package's npz
(``weights/npz_io.py``), which tpuseg's ``load_params_npz`` reads.
"""
import argparse


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="vit_b16_config")
    ap.add_argument("--data_dir", default=None,
                    help="root with one subdir per class")
    ap.add_argument("--weights", default=None, help="pretrained .pth/.npz")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--save", default="weights/vit_finetuned.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import os

    import numpy as np
    import torch

    from tpuseg_torch.data.native_loader import NativeImageLoader
    from tpuseg_torch.engine.classify import config_to_vit, load_vit_weights
    from tpuseg_torch.engine.config import get_config
    from tpuseg_torch.engine.vit_train import ViTTrainer, cosine_schedule
    from tpuseg_torch.ops.preprocess import vit_preprocess
    from tpuseg_torch.weights.from_jax import vit_jax_from_state_dict
    from tpuseg_torch.weights.npz_io import save_params_npz

    preset = get_config(args.config)
    rng = np.random.default_rng(0)
    if args.data_dir:
        classes = sorted(os.listdir(args.data_dir))
        samples = []
        for ci, cname in enumerate(classes):
            cdir = os.path.join(args.data_dir, cname)
            for f in os.listdir(cdir):
                samples.append((os.path.join(cdir, f), ci))
        preset = preset.copy({"num_classes": len(classes)})
        print(f"{len(samples)} images, {len(classes)} classes")
    else:
        samples = None
        print("no --data_dir: synthetic smoke-training")

    cfg = config_to_vit(preset)
    state_dict = load_vit_weights(args.weights, cfg) if args.weights else None
    trainer = ViTTrainer(cfg, lr_fn=cosine_schedule(args.lr, args.steps),
                         state_dict=state_dict, device=args.device)
    loader = NativeImageLoader()
    metrics = []
    for it in range(args.steps):
        if samples:
            idx = rng.integers(0, len(samples), args.batch_size)
            paths = [samples[i][0] for i in idx]
            labels = np.asarray([samples[i][1] for i in idx], np.int32)
            imgs, _ = loader.load_batch(paths, cfg.image_size, cfg.image_size)
        else:
            imgs = rng.integers(
                0, 255, (args.batch_size, cfg.image_size, cfg.image_size, 3)
            ).astype(np.uint8)
            labels = rng.integers(0, cfg.num_classes, args.batch_size).astype(
                np.int32)
        x = vit_preprocess(torch.from_numpy(imgs).to(trainer.device),
                           size=cfg.image_size)
        out = trainer.train_step(x, torch.from_numpy(labels), it)
        metrics.append({k: float(v) for k, v in out.items()})
        if (it + 1) % 10 == 0:
            print(f"step {it + 1}: loss {metrics[-1]['loss']:.4f} "
                  f"acc {metrics[-1]['acc']:.3f}", flush=True)
    save_params_npz(args.save, vit_jax_from_state_dict(
        trainer.model.state_dict()))
    print(f"saved {args.save}")
    return metrics


if __name__ == "__main__":
    main()
