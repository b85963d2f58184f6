"""The detectron family's training loop (port of
``tpuseg/engine/detectron_train_loop.py``, detectron's do_train): Mask
R-CNN and Faster R-CNN over FPN or C4, and RetinaNet, by the model's config.

Iteration-based to SOLVER.MAX_ITER with WarmupMultiStepLR, periodic
checkpoints and MetricLogger-style console lines. Each checkpoint is
written twice: ``model_{iter:07d}.pth`` in maskrcnn-benchmark's layout and
``model_{iter:07d}.npz``, the JAX package's param tree (its loop writes
that one), so that either package reads it back.
The host builds each batch on one canvas orientation with padded targets,
including each gt's mask cropped to its box for the mask loss (112x112
crops, pooled to the FPN's 28x28 targets or C4's 14x14; boxes-only models
do not read them).

The dataset is any object with the interface of the JAX package's
``CocoDetectionDataset``: ``image_ids``, ``coco.imgs[id]`` with ``width``
and ``height``, ``load_image(id)`` (RGB) and ``load_target(id)``
(``boxes`` xyxy, ``classes`` 0-based, ``masks`` [N, H, W], ``iscrowd``).
"""
from __future__ import annotations

import math
import time
from collections import deque

import numpy as np
import torch

from tpuseg_torch.engine.maskrcnn_engine import (build_model, model_module,
                                                 preprocess_image_bgr,
                                                 variant_of)
from tpuseg_torch.engine.trainer import (call_in_dtype, make_optimizer,
                                         save_checkpoint, set_lr,
                                         warmup_multistep_lr)
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.weights import from_jax
from tpuseg_torch.weights.npz_io import save_params_npz


class MovingAverage:
    """Sliding-window average of finite values (the port's copy of
    ``tpuseg/utils/logging.py::MovingAverage``)."""

    def __init__(self, max_window_size: int = 1000):
        self.max_window_size = max_window_size
        self.window = deque()
        self.sum = 0.0

    def add(self, elem: float) -> None:
        if math.isfinite(elem):
            self.window.append(elem)
            self.sum += elem
            if len(self.window) > self.max_window_size:
                self.sum -= self.window.popleft()

    def get_avg(self) -> float:
        return self.sum / max(len(self.window), 1)


def _bilinear_axis(t: np.ndarray, n: int):
    """Corner indices and weights along one axis; a corner outside [0, n)
    weighs 0 (a zero border)."""
    t0 = np.floor(t)
    f = t - t0
    i0 = t0.astype(np.int64)
    i1 = i0 + 1
    w0 = np.where((i0 >= 0) & (i0 < n), 1.0 - f, 0.0)
    w1 = np.where((i1 >= 0) & (i1 < n), f, 0.0)
    return np.clip(i0, 0, n - 1), np.clip(i1, 0, n - 1), w0, w1


def crop_mask(mask: np.ndarray, box: np.ndarray, crop: int) -> np.ndarray:
    """A gt mask [H, W] resampled over its exact float box onto a
    crop x crop grid -> float32 [crop, crop]: bilinear with a zero border,
    pixel centres at (i + 0.5) * extent / crop - 0.5. The numpy version of
    ``cv2.warpAffine(INTER_LINEAR | WARP_INVERSE_MAP)`` over the JAX
    package's inverse map (cv2 rounds source coordinates to 1/32 pixel and
    its weights to fixed point; this does not)."""
    x1, y1, x2, y2 = np.asarray(box, np.float64)
    bw = max(x2 - x1, 1.0)
    bh = max(y2 - y1, 1.0)
    grid = np.arange(crop) + 0.5
    y0, y1i, wy0, wy1 = _bilinear_axis(y1 + grid * bh / crop - 0.5,
                                       mask.shape[0])
    x0, x1i, wx0, wx1 = _bilinear_axis(x1 + grid * bw / crop - 0.5,
                                       mask.shape[1])
    m = mask.astype(np.float64)
    rows = wy0[:, None] * m[y0] + wy1[:, None] * m[y1i]  # [crop, W]
    return (rows[:, x0] * wx0 + rows[:, x1i] * wx1).astype(np.float32)


def build_train_example(dataset, iid, min_size=800, max_size=1333,
                        max_gt=64, crop=112, flip_prob=0.5, rng=None):
    """One image -> (canvas [Hc, Wc, 3] float32, (h, w) real size, padded
    targets: ``boxes`` [max_gt, 4], ``classes`` [max_gt] (-1 pads and
    crowd), ``mask_crops`` [max_gt, crop, crop] 0/1). Horizontal flip with
    probability ``flip_prob`` (INPUT.FLIP_PROB_TRAIN) drawn from ``rng``."""
    img = dataset.load_image(iid)  # RGB
    gt = dataset.load_target(iid)
    if rng is not None and rng.random() < flip_prob:
        w = img.shape[1]
        img = np.ascontiguousarray(img[:, ::-1])
        b = gt["boxes"].copy()
        # BoxList.transpose: flipped xmin = width - xmax - 1 (TO_REMOVE=1)
        b[:, [0, 2]] = w - gt["boxes"][:, [2, 0]] - 1
        gt["boxes"] = b
        gt["masks"] = np.ascontiguousarray(gt["masks"][:, :, ::-1])
    canvas, (th, tw), (sy, sx) = preprocess_image_bgr(
        img[:, :, ::-1], min_size, max_size)
    g = min(len(gt["boxes"]), max_gt)
    boxes = np.zeros((max_gt, 4), np.float32)
    classes = np.full((max_gt,), -1, np.int32)
    crops = np.zeros((max_gt, crop, crop), np.float32)
    for i in range(g):
        if gt["iscrowd"][i]:
            continue
        boxes[i] = gt["boxes"][i] * np.asarray([sx, sy, sx, sy], np.float32)
        classes[i] = gt["classes"][i]
        crops[i] = crop_mask(gt["masks"][i], gt["boxes"][i], crop) > 0.5
    return canvas, (th, tw), {
        "boxes": boxes, "classes": classes, "mask_crops": crops}


def train_losses(model, images: torch.Tensor, image_hw: torch.Tensor,
                 targets: dict, generator=None) -> dict:
    """The training forward of ``model``'s variant: the two-stage models
    draw their samplers' uniforms from ``generator``; RetinaNet samples
    nothing."""
    return model_module(model.cfg).forward_train_losses(
        model, images, image_hw, targets, generator=generator)


def train_step(model, optimizer, lr: float, images: torch.Tensor,
               image_hw: torch.Tensor, targets: dict, generator=None,
               compute_dtype: torch.dtype | None = None) -> dict:
    """One SGD step at ``lr`` on one batch -> the detached losses (on the
    device: reading them is the caller's synchronisation).
    ``compute_dtype`` (bf16) is the JAX loop's mixed precision: the
    forward and backward on a cast of the model and the images, the f32
    masters in the optimizer; the losses take f32 logits."""
    set_lr(optimizer, lr)
    if compute_dtype is not None:
        images = images.to(compute_dtype)
    losses = call_in_dtype(model, compute_dtype, train_losses, images,
                           image_hw, targets, generator)
    optimizer.zero_grad(set_to_none=True)
    losses["total"].backward()
    optimizer.step()
    return {k: v.detach() for k, v in losses.items()}


def batch_to_device(examples, dev) -> tuple:
    """build_train_example outputs -> (images [B, 3, Hc, Wc], image_hw
    [B, 2], targets) on ``dev``."""
    imgs, hws, tgts = zip(*examples)
    images = torch.from_numpy(np.stack(imgs).transpose(0, 3, 1, 2).copy())
    targets = {k: torch.from_numpy(np.stack([t[k] for t in tgts])).to(dev)
               for k in tgts[0]}
    return (images.to(dev), torch.tensor(hws, dtype=torch.int64, device=dev),
            targets)


def jax_tree(model) -> dict:
    """The JAX package's param tree of a detectron model of any variant
    (numpy f32 leaves), as its loop writes it to npz."""
    variant = variant_of(model.cfg)
    sd = model.state_dict()
    if variant == "c4":
        return from_jax.c4_jax_from_state_dict(sd)
    if variant == "retinanet":
        return from_jax.retinanet_jax_from_state_dict(sd)
    return from_jax.jax_from_state_dict(sd, model.cfg)


def do_train(dataset, cfg=None, model=None,
             base_lr=0.0025, steps=(120000, 160000), max_iter=180000,
             ims_per_batch=2, checkpoint_period=2500,
             output_dir="weights/detectron", log_every=20, max_steps=None,
             seed=3, device="cuda", min_size=800, max_size=1333,
             compute_dtype: torch.dtype | None = None):
    """Train a detectron model on ``device`` (the card unless the caller
    asks for ``"cpu"``) -> (model, iterations run, per-iteration loss dicts).

    ``model`` defaults to random weights from seed 0 (``build_model``) of
    ``cfg``'s variant (a MaskRCNNConfig, MaskRCNNC4Config or
    RetinaNetConfig; Mask R-CNN R-50-FPN's by default). The solver is
    upstream's e2e_mask_rcnn_R_50_FPN_1x at 2 images per batch, for every
    variant: SGD momentum 0.9, weight decay 1e-4, biases lr x2 without
    decay, WarmupMultiStepLR; the frozen stem and layer1 are left out.
    Images are shuffled per pass and flipped by a numpy generator seeded
    with ``seed``; the samplers draw from a
    ``torch.Generator`` on ``device`` seeded with ``seed``. Batches are
    bucketed by orientation so each shares one canvas; buckets persist
    across passes (a dataset with fewer images of one orientation than a
    batch still trains). ``compute_dtype`` bf16: see :func:`train_step`.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is unavailable")
    if model is None:
        model = build_model(cfg or M.MaskRCNNConfig(),
                            torch.Generator().manual_seed(0))
    model = model.to(dev).train()
    lr_fn = warmup_multistep_lr(base_lr=base_lr, steps=steps)
    opt = make_optimizer(model, base_lr)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = list(dataset.image_ids)
    if not ids:
        raise ValueError("dataset has no images")
    avgs: dict[str, MovingAverage] = {}
    t_avg = MovingAverage(50)
    history = []
    it = 0
    buckets = {"landscape": [], "portrait": []}
    while it < max_iter and (max_steps is None or it < max_steps):
        rng.shuffle(ids)
        for iid in ids:
            info = dataset.coco.imgs[iid]
            orient = ("landscape" if info["width"] >= info["height"]
                      else "portrait")
            buckets[orient].append(iid)
            if len(buckets[orient]) < ims_per_batch:
                continue
            chunk, buckets[orient] = buckets[orient], []
            images, hw, targets = batch_to_device(
                [build_train_example(dataset, i, min_size, max_size, rng=rng)
                 for i in chunk], dev)
            t0 = time.perf_counter()
            losses = train_step(model, opt, lr_fn(it), images, hw, targets,
                                gen, compute_dtype)
            losses = {k: float(v) for k, v in losses.items()}
            t_avg.add(time.perf_counter() - t0)
            history.append(losses)
            for k, v in losses.items():
                avgs.setdefault(k, MovingAverage(50)).add(v)
            it += 1
            if it % log_every == 0:
                terms = "  ".join(f"{k}: {a.get_avg():.4f}"
                                  for k, a in avgs.items())
                eta = (max_iter - it) * t_avg.get_avg() / 3600
                print(f"iter: {it}  {terms}  time: {t_avg.get_avg():.3f}  "
                      f"eta: {eta:.1f}h", flush=True)
            if it % checkpoint_period == 0:
                path = f"{output_dir}/model_{it:07d}"
                save_checkpoint(path + ".pth", model, it)
                save_params_npz(path + ".npz", jax_tree(model))
                print(f"saved {path}.pth and .npz", flush=True)
            if it >= max_iter or (max_steps is not None and it >= max_steps):
                break
    return model, it, history
