"""Pose2Seg training on the PyTorch port (Pose2Seg.jittor train.py; the
port's copy of ``tools/pose2seg_train.py``).

    python -m tpuseg_torch.tools.pose2seg_train \
        --images <train2017 dir> --annotations <person_keypoints json> \
        [--steps 15000] [--save weights/pose2seg_last.pth] [--device cpu]

The model starts from random weights (seed 0) and takes one image a step,
as the reference CLI does (it parses --batch_size and feeds one canvas a
step). The checkpoint is the model's state_dict with upstream's keys, or
for a ``--save`` path ending in ``.npz`` the JAX package's param tree;
``weights/pose2seg_map.py::load_pose2seg_weights`` reads either back.
"""
import argparse

import numpy as np


def train_example(dataset, image_id: int, cfg) -> dict | None:
    """One training canvas of an image, as the reference CLI builds it ->
    numpy arrays with a batch axis of 1: images [1, 3, S, S] normalised,
    theta [1, P, 2, 3], valid [1, P], gt_masks [1, P, S, S] in {0, 1} on
    the canvas, skel [1, P, O, O, 55]; None for an image without a person
    that has keypoints (two or more visible) and is not a crowd. The image
    goes to the canvas at int(h * scale) x int(w * scale)."""
    from tpuseg_torch.data.augment import resize_bilinear
    from tpuseg_torch.engine.pose2seg_engine import canvas_image
    from tpuseg_torch.eval import rle as rle_mod
    from tpuseg_torch.models import pose2seg as P2S

    pairs = []  # keypoints and masks from the same annotation
    for a in dataset.coco.imgToAnns[image_id]:
        if a.get("iscrowd", 0) or a.get("keypoints") is None:
            continue
        kp = np.asarray(a["keypoints"], np.float64).reshape(-1, 3)
        if (kp[:, 2] > 0).sum() >= 2:
            pairs.append((kp, a))
    if not pairs:
        return None
    img = dataset.load_image(image_id)
    h, w = img.shape[:2]
    s = cfg.input_size
    scale = s / max(h, w)
    nh, nw = int(h * scale), int(w * scale)
    pairs = pairs[:cfg.max_people]
    x = P2S.person_inputs(np.stack([kp for kp, _ in pairs]), cfg, scale)
    gt = np.zeros((1, cfg.max_people, s, s), np.float32)
    for i, (_, ann) in enumerate(pairs):
        if x["person_valid"][0, i]:
            m = rle_mod.decode(rle_mod.segm_to_rle(ann["segmentation"], h, w))
            gt[0, i, :nh, :nw] = resize_bilinear(m.astype(np.float32),
                                                 (nh, nw)) > 0.5
    return {"images": canvas_image(img, s, nh, nw).transpose(2, 0, 1)[None],
            "theta": x["theta"], "valid": x["person_valid"],
            "gt_masks": gt, "skel": x["skel"]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", default="./data/coco2017/train2017")
    ap.add_argument("--annotations",
                    default="./data/coco2017/annotations/"
                            "person_keypoints_train2017_pose2seg.json")
    ap.add_argument("--batch_size", type=int, default=4,
                    help="parsed as the reference CLI parses it; a step "
                         "takes one image")
    ap.add_argument("--steps", type=int, default=15000)
    ap.add_argument("--save", default="weights/pose2seg_last.pth")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
    from tpuseg_torch.engine.pose2seg_engine import save_pose2seg_checkpoint
    from tpuseg_torch.models import pose2seg as P2S
    from tpuseg_torch.models.pose2seg_loss import (Pose2SegTrainer,
                                                   warp_gt_to_aligned)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is unavailable")
    cfg = P2S.Pose2SegConfig()
    dataset = CocoDetectionDataset(args.images, args.annotations,
                                   label_map=None)
    model = P2S.build_model(cfg, torch.Generator().manual_seed(0)).to(device)
    trainer = Pose2SegTrainer(model)
    rng = np.random.default_rng(0)
    ids = list(dataset.image_ids)
    losses = []
    while len(losses) < args.steps:
        rng.shuffle(ids)
        steps_before = len(losses)
        for iid in ids:
            ex = train_example(dataset, iid, cfg)
            if ex is None or not ex["valid"].any():
                continue
            t = {k: torch.from_numpy(v).to(device) for k, v in ex.items()}
            gt_aligned = (warp_gt_to_aligned(t["gt_masks"], t["theta"],
                                             cfg.align_size) > 0.5).float()
            loss = trainer.train_step(t["images"], t["theta"], t["valid"],
                                      gt_aligned, skel=t["skel"])
            losses.append(float(loss))
            if len(losses) % 20 == 0:
                print(f"iter {len(losses)}: loss {losses[-1]:.4f}",
                      flush=True)
            if len(losses) >= args.steps:
                break
        if len(losses) == steps_before:
            raise ValueError(f"{args.annotations}: no image has a person "
                             "whose keypoints solve a pose")
    save_pose2seg_checkpoint(args.save, model)
    print(f"saved {args.save}")
    return losses


if __name__ == "__main__":
    main()
