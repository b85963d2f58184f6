"""YOLOv3 training on the PyTorch port (yolo.jittor train.py; the port's
copy of ``tools/yolo_train.py``).

    python -m tpuseg_torch.tools.yolo_train --images <train2017 dir> \
        --annotations <instances json> [--img_size 416] [--batch_size 8] \
        [--steps 500000] [--lr 1e-3] [--pretrained_backbone \
        darknet53.conv.74] [--save weights/yolov3.npz] [--device cuda]

Each batch: images shuffled by a numpy generator seeded with 0, each
downscaled to fit a canvas of twice ``--img_size`` (never upscaled), crowd
annotations dropped, at most 64 ground truths an image, mapped into
letterbox coordinates; the letterbox runs on the device. The params are
saved as the JAX package's npz (``weights/npz_io.py``), which tpuseg's
``load_params_npz`` and the port's ``YoloPredictor`` read.
"""
import argparse

import numpy as np

MAX_GT = 64


def train_batch(dataset, ids: list, img_size: int) -> tuple:
    """The training CLI's batch of ``ids`` -> (images uint8 [B, 2S, 2S, 3],
    hw [B, 2], gt boxes [B, 64, 4] in letterbox px, classes [B, 64], -1
    pads)."""
    from tpuseg_torch.data.image_io import resize_bilinear_u8

    b, maxdim = len(ids), img_size * 2
    batch = np.zeros((b, maxdim, maxdim, 3), np.uint8)
    hw = np.zeros((b, 2), np.int32)
    boxes = np.zeros((b, MAX_GT, 4), np.float32)
    classes = np.full((b, MAX_GT), -1, np.int32)
    for i, iid in enumerate(ids):
        img = dataset.load_image(iid)
        gt = dataset.load_target(iid, with_masks=False)
        h, w = img.shape[:2]
        s = min(maxdim / w, maxdim / h, 1.0)
        if s < 1.0:
            img = resize_bilinear_u8(img, int(h * s), int(w * s))
        h, w = img.shape[:2]
        batch[i, :h, :w] = img
        hw[i] = (h, w)
        g = min(len(gt["boxes"]), MAX_GT)
        # the ground truth into the letterbox of the image as loaded
        scale = img_size / max(h, w)
        pad_x = (img_size - w * scale) / 2
        pad_y = (img_size - h * scale) / 2
        bb = gt["boxes"][:g] * s * scale
        bb[:, 0::2] += pad_x
        bb[:, 1::2] += pad_y
        boxes[i, :g] = bb
        classes[i, :g] = gt["classes"][:g]
    return batch, hw, boxes, classes


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", default="./data/coco/train2017")
    ap.add_argument("--annotations",
                    default="./data/coco/annotations/instances_train2017.json")
    ap.add_argument("--img_size", type=int, default=416)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=500000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--pretrained_backbone", default=None,
                    help="darknet53.conv.74")
    ap.add_argument("--save", default="weights/yolov3.npz")
    ap.add_argument("--save_every", type=int, default=5000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
    from tpuseg_torch.engine.detectron_train_loop import MovingAverage
    from tpuseg_torch.engine.yolo_engine import YoloTrainer
    from tpuseg_torch.models import yolov3 as Y
    from tpuseg_torch.weights.from_jax import yolov3_jax_from_state_dict
    from tpuseg_torch.weights.npz_io import save_params_npz

    cfg = Y.YoloV3Config(input_size=args.img_size)
    # crowd regions must not become positive targets (the reference's YOLO
    # label conversion drops them)
    dataset = CocoDetectionDataset(args.images, args.annotations,
                                   include_crowd=False)
    state_dict = None
    if args.pretrained_backbone:
        from tpuseg_torch.weights.darknet_io import load_darknet53_backbone

        state_dict = load_darknet53_backbone(
            args.pretrained_backbone,
            Y.build_model(cfg, torch.Generator().manual_seed(0))).state_dict()
    trainer = YoloTrainer(cfg, state_dict=state_dict, lr=args.lr,
                          device=args.device)

    def save():
        save_params_npz(args.save,
                        yolov3_jax_from_state_dict(trainer.model.state_dict()))
        print(f"saved {args.save}")

    rng = np.random.default_rng(0)
    ids = list(dataset.image_ids)
    if len(ids) < args.batch_size:
        raise ValueError(f"{len(ids)} images, fewer than one batch of "
                         f"{args.batch_size}")
    avg = MovingAverage(100)
    losses = []
    while len(losses) < args.steps:
        rng.shuffle(ids)
        for start in range(0, len(ids) - args.batch_size + 1,
                           args.batch_size):
            batch = train_batch(dataset, ids[start:start + args.batch_size],
                                args.img_size)
            out = trainer.train_step(*map(torch.from_numpy, batch),
                                     len(losses))
            losses.append(float(out["total"]))
            avg.add(losses[-1])
            if len(losses) % 20 == 0:
                print(f"iter {len(losses)}: loss {avg.get_avg():.4f}",
                      flush=True)
            if len(losses) % args.save_every == 0:
                save()
            if len(losses) >= args.steps:
                break
    save()
    return losses


if __name__ == "__main__":
    main()
