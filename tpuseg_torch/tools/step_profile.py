"""Where a detectron model's training step, or its forward, spends the
card's time.

    python3 -m tpuseg_torch.tools.step_profile [--tree DIR] [--steps 3]
        [--model maskrcnn|c4|faster_rcnn|retinanet] [--forward]

Builds the smoke's configuration from ``chip_smoke.py`` of the checkout
``--tree`` (default: this one; another checkout, for example the parent
commit unpacked under the ignored ``build/``, to compare two trees on one
card): Mask R-CNN R50-FPN (phase 9's weights) or, with ``--model``, one of
phase 14's yamls and weights (``chip_smoke.family_state_dict``: its
training init, or with ``--forward`` its calibrated inference weights);
B = 2 on the 800x1344 canvas, synthetic images from the smoke's seeds,
TF32 convolutions. Times four runs of 5 steps (or forwards) with CUDA
events, then traces ``--steps`` of them with ``torch.profiler`` and
prints, per step: the wall time, the device's busy time (the sum of its
kernels' times) and idle share, the RoIAlign backward kernel's time and
launches, and the kernels that take the most time. Needs the card.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tree", default=ROOT, type=Path)
    ap.add_argument("--steps", default=3, type=int)
    ap.add_argument("--top", default=12, type=int)
    ap.add_argument("--model", default="maskrcnn",
                    choices=("maskrcnn", "c4", "faster_rcnn", "retinanet"))
    ap.add_argument("--forward", action="store_true",
                    help="profile a B = 2 forward instead of a step")
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    # the tree's own package, not the one this module was imported from
    for name in [m for m in sys.modules if m.split(".")[0] == "tpuseg_torch"]:
        del sys.modules[name]
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as S

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the profile needs a GPU")
    dev = torch.device("cuda", 0)
    if args.model == "maskrcnn":
        cfg = S.M.MaskRCNNConfig()
        model = S.M.build_model(cfg)
        sd = S.synthetic_state_dict(model, S.SEED + 7)
        sd["backbone.body.stem.bn1.running_var"] *= S.PIXEL_VAR
    else:
        _, cfg = S.ME.model_config_from_node(S.family_node(args.model))
        model = S.ME.build_model(cfg)
        sd, _ = S.family_state_dict(args.model, cfg, dev,
                                    train=not args.forward)
    model.load_state_dict(sd, strict=True)
    model = model.to(dev)
    data = S.SyntheticDataset(S.SEED + 7)
    rng = np.random.default_rng(S.SEED + 8)
    batch = S.TL.batch_to_device([S.TL.build_train_example(data, i, rng=rng)
                                  for i in data.image_ids[:2]], dev)
    if args.forward:
        forward = S.ME.model_module(cfg).forward_inference
        model.eval()

        def step():
            with torch.inference_mode():
                forward(model, *batch[:2])
    else:
        opt = S.make_optimizer(model, 0.0025)
        gen = torch.Generator(device=dev).manual_seed(S.SEED)

        def step():
            S.TL.train_step(model, opt, 0.0025 / 3, *batch, gen)

    runs = [S.cuda_time_ms(step, iters=5, warmup=2) for _ in range(4)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.steps):
            step()
        stop.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(stop) / args.steps
    kern = [k for k in prof.key_averages()
            if k.device_type == DeviceType.CUDA]
    busy = sum(k.self_device_time_total for k in kern) / 1e3 / args.steps
    k3 = [k for k in kern if "roi_align_bwd_kernel" in k.key]
    k3_ms = sum(k.self_device_time_total for k in k3) / 1e3 / args.steps
    k3_n = sum(k.count for k in k3) / args.steps
    card = S.nvidia_smi()
    what = f"{args.model} {'forward' if args.forward else 'train step'}"
    print(f"[{tree.name}] {what} B=2 800x1344, runs of 5: "
          f"{', '.join(f'{t:.3f}' for t in runs)} ms; traced "
          f"{args.steps} steps: wall {wall:.3f} ms per step, device busy "
          f"{busy:.3f} ms ({100 * (1 - busy / wall):.1f} % idle), "
          f"roi_align_bwd {k3_ms:.4f} ms in {k3_n:g} launches [{card}]")
    for k in sorted(kern, key=lambda k: -k.self_device_time_total)[:args.top]:
        ms = k.self_device_time_total / 1e3 / args.steps
        print(f"[{tree.name}]   {ms:9.4f} ms x{k.count / args.steps:6g}  "
              f"{k.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
