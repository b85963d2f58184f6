"""Where a model's training step, or its forward, spends the card's time.

    python3 -m tpuseg_torch.tools.step_profile [--tree DIR] [--steps 3]
        [--model maskrcnn|c4|faster_rcnn|retinanet|pose2seg|yolov3|vit]
        [--forward]

Builds the smoke's configuration from ``chip_smoke.py`` of the checkout
``--tree`` (default: this one; another checkout, for example the parent
commit unpacked under the ignored ``build/``, to compare two trees on one
card): Mask R-CNN R50-FPN (phase 9's weights) or, with ``--model``, one of
phase 14's yamls and weights (``chip_smoke.family_state_dict``: its
training init, or with ``--forward`` its calibrated inference weights);
B = 2 on the 800x1344 canvas, synthetic images from the smoke's seeds,
TF32 convolutions. ``--model pose2seg`` is phase 15's: the calibrated
synthetic weights, the forward at B = 1 with 16 people on the 512 canvas,
the training step (with the ground-truth warp) at B = 4 over the smoke's
keypoint dataset. ``--model yolov3`` and ``--model vit`` are phase 16's:
YOLOv3-416's device pipeline (letterbox, DarkNet-53, decode, top-k, K1)
at B = 8 from the 640x640 canvas, or its training step at B = 8 on the
832 canvas over the smoke's COCO dataset; ViT-B/16's forward or training
step at B = 32. Times four runs of 5 steps (or forwards) with CUDA
events, then traces ``--steps`` of them with ``torch.profiler`` and
prints, per step: the wall time, the device's busy time (the sum of its
kernels' times) and idle share, the port's own kernels' time and
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
                    choices=("maskrcnn", "c4", "faster_rcnn", "retinanet",
                             "pose2seg", "yolov3", "vit"))
    ap.add_argument("--forward", action="store_true",
                    help="profile a forward instead of a step")
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    # the tree's own package, not the one this module was imported from
    for name in [m for m in sys.modules if m.split(".")[0] == "tpuseg_torch"]:
        del sys.modules[name]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as S

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the profile needs a GPU")
    dev = torch.device("cuda", 0)
    if args.model == "pose2seg":
        step, shape = pose2seg_step(S, dev, args.forward)
    elif args.model == "yolov3":
        step, shape = yolov3_step(S, dev, args.forward)
    elif args.model == "vit":
        step, shape = vit_step(S, dev, args.forward)
    else:
        step, shape = detectron_step(S, dev, args.model, args.forward)
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
    rows = prof.key_averages()
    # a device row named as a host row is the profiler's span of a
    # record_function range (Optimizer.step, ...), over kernels that are
    # rows of their own: only the kernels' rows are the device's work
    host = {k.key for k in rows if k.device_type == DeviceType.CPU}
    kern = [k for k in rows
            if k.device_type == DeviceType.CUDA and k.key not in host]
    busy = sum(k.self_device_time_total for k in kern) / 1e3 / args.steps
    ours = {k.key[k.key.index(n):].split("(")[0]: k for k in kern
            for n in PORT_KERNELS if n in k.key}
    card = S.nvidia_smi()
    what = f"{args.model} {'forward' if args.forward else 'train step'}"
    print(f"[{tree.name}] {what} {shape}, runs of 5: "
          f"{', '.join(f'{t:.3f}' for t in runs)} ms; traced "
          f"{args.steps} steps: wall {wall:.3f} ms per step, device busy "
          f"{busy:.3f} ms ({100 * (1 - busy / wall):.1f} % idle) [{card}]")
    for name, k in ours.items():
        print(f"[{tree.name}]   the port's {name}: "
              f"{k.self_device_time_total / 1e3 / args.steps:.4f} ms in "
              f"{k.count / args.steps:g} launches per step")
    for k in sorted(kern, key=lambda k: -k.self_device_time_total)[:args.top]:
        ms = k.self_device_time_total / 1e3 / args.steps
        print(f"[{tree.name}]   {ms:9.4f} ms x{k.count / args.steps:6g}  "
              f"{k.key[:100]}")
    return 0


# the hand-written kernels of tpuseg_torch/csrc, by name
PORT_KERNELS = ("nms_mask_kernel", "nms_reduce_kernel", "roi_align_kernel",
                "roi_align_bwd_kernel", "dcn_sample_kernel",
                "dcn_sample_bwd_kernel")


def detectron_step(S, dev, name: str, forward: bool) -> tuple:
    """A detectron model's B = 2 step (or forward) -> (closure, shape)."""
    import numpy as np
    import torch

    if name == "maskrcnn":
        cfg = S.M.MaskRCNNConfig()
        model = S.M.build_model(cfg)
        sd = S.synthetic_state_dict(model, S.SEED + 7)
        sd["backbone.body.stem.bn1.running_var"] *= S.PIXEL_VAR
    else:
        _, cfg = S.ME.model_config_from_node(S.family_node(name))
        model = S.ME.build_model(cfg)
        sd, _ = S.family_state_dict(name, cfg, dev, train=not forward)
    model.load_state_dict(sd, strict=True)
    model = model.to(dev)
    data = S.SyntheticDataset(S.SEED + 7)
    rng = np.random.default_rng(S.SEED + 8)
    batch = S.TL.batch_to_device([S.TL.build_train_example(data, i, rng=rng)
                                  for i in data.image_ids[:2]], dev)
    if forward:
        fwd = S.ME.model_module(cfg).forward_inference
        model.eval()

        def step():
            with torch.inference_mode():
                fwd(model, *batch[:2])
    else:
        opt = S.make_optimizer(model, 0.0025)
        gen = torch.Generator(device=dev).manual_seed(S.SEED)

        def step():
            S.TL.train_step(model, opt, 0.0025 / 3, *batch, gen)
    return step, "B=2 800x1344"


def pose2seg_step(S, dev, forward: bool) -> tuple:
    """Phase 15's Pose2Seg forward (B = 1, 16 people) or training step
    (B = 4, the ground-truth warp included) -> (closure, shape)."""
    import tempfile

    import numpy as np
    import torch

    cfg = S.P2S.Pose2SegConfig()
    rng = np.random.default_rng(S.SEED + 31)
    cases = [(S.textured_image(rng, h, w), S.template_people(rng, n, h, w))
             for (h, w), n in S.P2S_IMAGES]
    sd = S.synthetic_pose2seg_state_dict(cfg, S.SEED + 30)
    S.calibrate_pose2seg(sd, cfg, *cases[0], dev)
    pred = S.P2SE.Pose2SegPredictor(cfg, state_dict=sd, device=dev)
    if forward:
        x, inp = S.p2s_canvas(pred, *cases[1])
        heads = (inp["theta"], inp["inv_theta"], inp["person_valid"],
                 inp["skel"])

        def step():
            with torch.inference_mode():
                pred.model(x, *heads)
        return step, f"B=1 {cfg.max_people} people {cfg.input_size}"
    with tempfile.TemporaryDirectory() as tmp:
        img_dir, ann = S.write_keypoint_dataset(Path(tmp), S.SEED + 32)
        ds = S.CocoDetectionDataset(img_dir, ann, label_map=None)
        batch = S.p2s_batch(ds, cfg, dev)
    trainer = S.P2SL.Pose2SegTrainer(pred.model)

    def step():
        gt = (S.P2SL.warp_gt_to_aligned(batch["gt_masks"], batch["theta"],
                                        cfg.align_size) > 0.5).float()
        trainer.train_step(batch["images"], batch["theta"], batch["valid"],
                           gt, skel=batch["skel"])
    return step, f"B={S.P2S_BATCH} {cfg.input_size}"


def yolov3_step(S, dev, forward: bool) -> tuple:
    """Phase 16's YOLOv3-416 at B = 8: the predictor's device pipeline on
    the smoke's images, or the training step on the 832 canvas ->
    (closure, shape)."""
    import tempfile

    import numpy as np
    import torch

    from tpuseg_torch.tools.yolo_train import train_batch

    cfg = S.Y3.YoloV3Config()
    with tempfile.TemporaryDirectory() as tmp:
        weights = Path(tmp) / "yolov3.weights"
        S.write_darknet_weights(weights, cfg, S.SEED + 40)
        if forward:
            pred = S.YOE.YoloPredictor(cfg, weights=str(weights), device=dev)
            rng = np.random.default_rng(S.SEED + 41)
            batch, hw = S.yolo_canvas([S.textured_image(rng, h, w)
                                       for h, w in S.YOLO_IMAGES])
            x = torch.from_numpy(batch).to(dev)
            h = torch.from_numpy(hw).to(dev)

            def step():
                with torch.inference_mode():
                    pred.detect(x, h)
            return step, f"B={len(hw)} {cfg.input_size} from {batch.shape[1]}"
        trainer = S.YOE.YoloTrainer(cfg, weights=str(weights), device=dev)
        img_dir, ann, _ = S.write_coco_dataset(Path(tmp) / "coco",
                                               S.SEED + 20)
        ds = S.CocoDetectionDataset(img_dir, ann, include_crowd=False)
        host = train_batch(ds, ds.image_ids[:S.YOLO_BATCH], cfg.input_size)
    tb = [torch.from_numpy(a).to(dev) for a in host]

    def step():
        trainer.train_step(*tb, S.YOE.BURN_IN)
    return step, f"B={S.YOLO_BATCH} {cfg.input_size} from {tb[0].shape[1]}"


def vit_step(S, dev, forward: bool) -> tuple:
    """Phase 16's ViT-B/16 forward or training step at B = 32 ->
    (closure, shape)."""
    import numpy as np
    import torch

    vcfg = S.VC.config_to_vit(S.get_config(S.VIT_CONFIG))
    sd = S.synthetic_vit_state_dict(vcfg, S.SEED + 50)
    rng = np.random.default_rng(S.SEED + 51)
    x = S.VIT_PRE(S.vit_images(rng, S.VIT_BATCH, vcfg.image_size).to(dev),
                  size=vcfg.image_size)
    shape = f"B={S.VIT_BATCH} {vcfg.image_size}"
    if forward:
        model = S.VC.build_vit(vcfg, state_dict=sd).to(dev).eval()

        def step():
            with torch.inference_mode():
                model(x)
        return step, shape
    trainer = S.VT.ViTTrainer(vcfg, lr_fn=lambda it: S.VIT_LR, state_dict=sd,
                              device=dev)
    labels = torch.from_numpy(rng.integers(0, vcfg.num_classes,
                                           S.VIT_BATCH))

    def step():
        trainer.train_step(x, labels, 0)
    return step, shape


if __name__ == "__main__":
    sys.exit(main())
