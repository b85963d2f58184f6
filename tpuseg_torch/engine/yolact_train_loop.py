"""YOLACT training loop (port of ``tpuseg/engine/yolact_train_loop.py``,
Yolact ``train.py``).

The host: dataset -> SSD augmentation (``data/augment.py``) -> padded
targets with the gt masks downsampled to the prototypes' and P3's sizes.
The device: one step of ``forward_train`` + ``total_loss`` + backward +
SGD. Console lines follow the reference's loss terms (B/C/M/S/I, ETA from
moving averages); checkpoints are ``<cfg>_<epoch>_<iter>.pth``.

The dataset is any object with ``image_ids``, ``load_image(id)`` (RGB
uint8) and ``load_target(id)`` (``boxes`` xyxy pixels, ``classes``
0-based, ``masks`` [N, H, W], ``iscrowd``), as the JAX loop takes.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from tpuseg_torch.data.augment import (AugmentConfig, resize_bilinear,
                                       ssd_augment)
from tpuseg_torch.engine.detectron_train_loop import MovingAverage
from tpuseg_torch.engine.trainer import (call_in_dtype, ckpt_path,
                                         make_yolact_optimizer,
                                         parse_ckpt_iter,
                                         save_yolact_checkpoint, set_lr,
                                         yolact_lr_schedule)
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.models import yolact_loss as YL
from tpuseg_torch.weights.from_jax import yolact_jax_from_state_dict
from tpuseg_torch.weights.npz_io import save_params_npz
from tpuseg_torch.weights.yolact_map import load_yolact_weights

LOSS_KEYS = ("B", "C", "M", "S", "I")
MAX_GT = 32  # gt slots per image in a batch's padded targets


def build_targets_np(gt: dict, aug_img_size: int, proto_size: int,
                     sem_size: int, max_gt: int) -> dict:
    """One augmented image's targets -> fixed-shape numpy arrays: boxes
    [G, 4], classes [G] (-1 padding), crowd [G], and the masks bilinearly
    resized to the prototypes' and P3's sizes and binarised at 0.5."""
    g = min(len(gt["classes"]), max_gt)
    boxes = np.zeros((max_gt, 4), np.float32)
    classes = np.full((max_gt,), -1, np.int32)
    crowd = np.zeros((max_gt,), bool)
    masks_proto = np.zeros((max_gt, proto_size, proto_size), np.float32)
    masks_sem = np.zeros((max_gt, sem_size, sem_size), np.float32)
    for i in range(g):
        boxes[i] = gt["boxes"][i]
        classes[i] = gt["classes"][i]
        crowd[i] = bool(gt.get("iscrowd", np.zeros(g))[i])
        m = gt["masks"][i].astype(np.float32)
        masks_proto[i] = resize_bilinear(m, proto_size) > 0.5
        masks_sem[i] = resize_bilinear(m, sem_size) > 0.5
    return {"boxes": boxes, "classes": classes, "crowd": crowd,
            "masks_proto": masks_proto, "masks_sem": masks_sem}


def batch_iterator(dataset, cfg: Y.YolactConfig, rng: np.random.Generator,
                   batch_size: int):
    """Endless shuffled batches of (images [B, S, S, 3] normalised,
    targets) numpy arrays; crowds ride along, after the real gts, so that
    the ``MAX_GT`` cap never drops a real gt for a crowd."""
    acfg = AugmentConfig(size=cfg.img_size)
    sem = Y.level_sizes(cfg)[0]
    ids = list(dataset.image_ids)
    if len(ids) < batch_size:
        raise ValueError(
            f"dataset has {len(ids)} images < batch_size {batch_size}")
    while True:
        rng.shuffle(ids)
        for start in range(0, len(ids) - batch_size + 1, batch_size):
            imgs, tgts = [], []
            for iid in ids[start:start + batch_size]:
                img = dataset.load_image(iid)
                gt = dataset.load_target(iid)
                aimg, aboxes, aclasses, amasks, acrowd = ssd_augment(
                    rng, img, gt["boxes"], gt["classes"], gt["masks"], acfg,
                    iscrowd=gt["iscrowd"].astype(bool))
                order = np.argsort(acrowd, kind="stable")
                aboxes, aclasses, acrowd = (aboxes[order], aclasses[order],
                                            acrowd[order])
                if len(amasks):
                    amasks = amasks[order]
                tgts.append(build_targets_np(
                    {"boxes": aboxes, "classes": aclasses, "masks": amasks,
                     "iscrowd": acrowd}, cfg.img_size, 2 * sem, sem, MAX_GT))
                imgs.append(aimg)
            yield np.stack(imgs), {k: np.stack([t[k] for t in tgts])
                                   for k in tgts[0]}


def batch_to_device(images: np.ndarray, targets: dict, dev) -> tuple:
    """batch_iterator's arrays -> (images [B, 3, S, S], targets) on
    ``dev``; classes as int64."""
    x = torch.from_numpy(images.transpose(0, 3, 1, 2).copy()).to(dev)
    t = {k: torch.from_numpy(v).to(dev) for k, v in targets.items()}
    t["classes"] = t["classes"].long()
    return x, t


def train_losses(model: Y.Yolact, images, targets, priors, draws, loss_cfg,
                 cdt=None) -> dict:
    """``forward_train`` and ``total_loss``; with ``cdt`` (the model's
    compute dtype) the predictions and the semantic logits go to the loss
    in f32, and FastMaskIoUNet runs on a ``cdt`` cast of the masks and
    returns f32, as in ``YolactTrainer``."""
    preds, sem = model.forward_train(images)
    maskiou_net = model.maskiou_net
    if cdt is not None:
        preds = {k: v.float() for k, v in preds.items()}
        sem = sem.float()
        if maskiou_net is not None:
            def maskiou_net(m, net=model.maskiou_net):
                return net(m.to(cdt)).float()
    return YL.total_loss(preds, sem, targets, priors, draws, loss_cfg,
                         maskiou_net=maskiou_net)


def train_step(model: Y.Yolact, optimizer, lr: float, images: torch.Tensor,
               targets: dict, priors: torch.Tensor, draws: torch.Tensor,
               loss_cfg: YL.YolactLossConfig,
               compute_dtype: torch.dtype | None = None) -> dict:
    """One SGD step at ``lr``: ``forward_train``, ``total_loss`` on the
    mask-subset ``draws`` [B, N], backward, the optimizer's step -> the
    detached losses (on the device: reading them is the caller's
    synchronisation). ``compute_dtype`` (bf16) is ``YolactTrainer``'s
    mixed precision: the forward and backward on a cast of the model and
    the images (:func:`~tpuseg_torch.engine.trainer.cast_floats`), the f32
    masters in the optimizer."""
    set_lr(optimizer, lr)
    if compute_dtype is not None:
        images = images.to(compute_dtype)
    losses = call_in_dtype(model, compute_dtype, train_losses, images,
                           targets, priors, draws, loss_cfg, compute_dtype)
    optimizer.zero_grad(set_to_none=True)
    losses["total"].backward()
    optimizer.step()
    return {k: v.detach() for k, v in losses.items()}


def train(dataset, model_cfg: Y.YolactConfig, batch_size=8, max_iter=800000,
          save_every=10000, save_folder="weights/", cfg_name="yolact_base",
          resume=None, start_iter=-1, log_every=10, max_steps=None,
          loss_cfg=None, model=None, device="cuda", save_format="pth",
          compute_dtype: torch.dtype | None = None):
    """yolact train.py's main loop on ``device`` (the card unless the
    caller asks for ``"cpu"``) -> (model, iterations run, per-iteration
    loss dicts).

    ``loss_cfg`` defaults to ``YolactLossConfig()``, as in the JAX loop;
    ``configs.presets.yolact_loss_config`` gives a preset's (YOLACT++: the
    FastMaskIoUNet term). ``model`` defaults to ``build_model`` with random
    weights from seed 0; ``resume`` loads a ``<cfg>_<epoch>_<iter>.pth``
    through ``load_yolact_weights`` and continues from its iteration (``start_iter`` >= 0 overrides it).
    BatchNorm trains (batch statistics, running statistics updated) unless
    the batch is below 6, where yolact disables it (``freeze_bn``).
    Augmentation draws from ``numpy.random.default_rng(42)``, the
    mask-subset draws from a ``torch.Generator`` on ``device`` seeded
    with 7. ``save_format`` "pth" writes upstream's state_dict, "npz" the
    JAX package's param tree (``<cfg>_<epoch>_<iter>.npz``);
    ``compute_dtype`` bf16: see :func:`train_step`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is unavailable")
    loss_cfg = loss_cfg or YL.YolactLossConfig()
    if model is None:
        model = Y.build_model(model_cfg, torch.Generator().manual_seed(0))
    it = 0
    if resume:  # through the weight map, as tpuseg's resume
        model.load_state_dict(load_yolact_weights(resume), strict=True)
        it = parse_ckpt_iter(resume) if start_iter < 0 else start_iter
    model.freeze_bn = batch_size < 6
    model = model.to(dev).train()
    lr_fn = yolact_lr_schedule()
    opt = make_yolact_optimizer(model)
    priors = torch.from_numpy(Y.make_priors_np(model_cfg)).to(dev)
    batches = batch_iterator(dataset, model_cfg, np.random.default_rng(42),
                             batch_size)
    gen = torch.Generator(device=dev).manual_seed(7)
    avgs: dict[str, MovingAverage] = {}
    t_avg = MovingAverage(100)
    epoch_size = max(len(dataset.image_ids) // batch_size, 1)
    history = []
    while it < max_iter and (max_steps is None or len(history) < max_steps):
        images, targets = batch_to_device(*next(batches), dev)
        draws = torch.rand((batch_size, priors.shape[0]), generator=gen,
                           device=dev)
        t0 = time.perf_counter()
        losses = train_step(model, opt, lr_fn(it), images, targets, priors,
                            draws, loss_cfg, compute_dtype)
        losses = {k: float(v) for k, v in losses.items()}
        t_avg.add(time.perf_counter() - t0)
        history.append(losses)
        for k, v in losses.items():
            avgs.setdefault(k, MovingAverage(100)).add(v)
        it += 1
        if it % log_every == 0:
            eta = (max_iter - it) * t_avg.get_avg()
            terms = " | ".join(f"{k}: {avgs[k].get_avg():.3f}"
                               for k in LOSS_KEYS if k in avgs)
            print(f"[{it // epoch_size:3d}] {it:7d} || {terms} || "
                  f"T: {avgs['total'].get_avg():.3f} || "
                  f"ETA: {eta / 3600:.2f}h || {t_avg.get_avg():.3f}s/it",
                  flush=True)
        if it % save_every == 0:
            path = ckpt_path(save_folder, cfg_name, it // epoch_size, it,
                             save_format)
            if save_format == "npz":
                save_params_npz(path, yolact_jax_from_state_dict(
                    model.state_dict(), model_cfg))
            else:
                save_yolact_checkpoint(path, model)
            print(f"saved {path}", flush=True)
    return model, it, history
