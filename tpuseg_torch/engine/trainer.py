"""The solvers (port of ``tpuseg/engine/trainer.py``): detectron's
WarmupMultiStepLR, maskrcnn-benchmark's SGD parameter groups and checkpoint
writer for Mask R-CNN; yolact's warm-up and step schedule, its SGD and its
``<cfg>_<epoch>_<iter>.pth`` checkpoints for YOLACT.

``torch.optim.SGD`` (momentum 0.9, no dampening) computes what the JAX
``sgd_update`` computes: buf = m * buf + (grad + wd * p); p -= lr * buf,
its first buffer being the first gradient, as from a zeroed one.
"""
from __future__ import annotations

import os
import re

import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm

from tpuseg_torch.weights.yolact_map import upstream_state_dict


def yolact_lr_schedule(base_lr=1e-3, warmup_until=500, warmup_init=1e-4,
                       steps=(280000, 600000, 700000, 750000), gamma=0.1):
    """yolact train.py's ``set_lr``: linear warm-up from ``warmup_init``
    over ``warmup_until`` iterations, then ``gamma`` per step passed."""

    def lr(it: int) -> float:
        if it < warmup_until:
            return warmup_init + (base_lr - warmup_init) * it / warmup_until
        return base_lr * gamma ** sum(it >= s for s in steps)

    return lr


def warmup_multistep_lr(base_lr=0.01, steps=(120000, 160000), gamma=0.1,
                        warmup_factor=1.0 / 3, warmup_iters=500,
                        warmup_method="linear"):
    """maskrcnn-benchmark WarmupMultiStepLR as a function of the iteration."""

    def lr(it: int) -> float:
        wf = 1.0
        if it < warmup_iters:
            if warmup_method == "linear":
                alpha = it / warmup_iters
                wf = warmup_factor * (1 - alpha) + alpha
            else:
                wf = warmup_factor
        return base_lr * wf * gamma ** sum(it >= s for s in steps)

    return lr


BIAS_LR_FACTOR = 2.0  # SOLVER.BIAS_LR_FACTOR; SOLVER.WEIGHT_DECAY_BIAS is 0


def detectron_param_groups(model: nn.Module, base_lr: float,
                           weight_decay: float) -> list:
    """maskrcnn-benchmark make_optimizer's groups: weights at the base lr
    with ``weight_decay``, biases at ``BIAS_LR_FACTOR`` times the lr without
    decay. Frozen parameters (the stem and layer1 at FREEZE_CONV_BODY_AT 2)
    are left out, and FrozenBN's tensors are buffers, so neither trains.
    Each group carries its ``lr_factor`` for :func:`set_lr`."""
    weights, biases = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (biases if name.endswith("bias") else weights).append(p)
    return [
        {"params": weights, "lr": base_lr, "lr_factor": 1.0,
         "weight_decay": weight_decay},
        {"params": biases, "lr": base_lr * BIAS_LR_FACTOR,
         "lr_factor": BIAS_LR_FACTOR, "weight_decay": 0.0},
    ]


def make_optimizer(model: nn.Module, base_lr: float, momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> torch.optim.SGD:
    return torch.optim.SGD(
        detectron_param_groups(model, base_lr, weight_decay), lr=base_lr,
        momentum=momentum)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The schedule's lr for this iteration, times each group's factor."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_factor"]


def save_checkpoint(path: str, model: nn.Module, iteration: int) -> None:
    """maskrcnn-benchmark Checkpointer layout: ``{"model": state_dict,
    "iteration": iteration}``, upstream keys, CPU tensors. ``build_model``
    + ``load_state_dict(strict=True)`` (or ``load_detectron_weights``)
    reads it back."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model": sd, "iteration": iteration}, path)


def cast_floats(model: nn.Module, dtype: torch.dtype) -> dict:
    """The JAX ``cast_floats`` for ``torch.func.functional_call``: every
    floating parameter and buffer of ``model`` cast to ``dtype``, by name.
    The casts are differentiable, so the gradients come back to the f32
    masters, which stay in the optimizer (the JAX cast's transpose).

    A BatchNorm in train mode computes its batch statistics in f32 (the JAX
    ``batch_norm`` under ``bn_train_mode``): its weight and bias are
    rounded to ``dtype`` and kept f32, and its running statistics are left
    out, so that torch's BatchNorm takes its mixed-precision path and
    updates the module's own f32 buffers in place, momentum 0.1 and the
    unbiased variance (the JAX ``bn_apply_stats``)."""
    out = {}
    for mname, m in model.named_modules():
        train_bn = isinstance(m, _BatchNorm) and m.training
        pre = f"{mname}." if mname else ""
        for name, t in [*m.named_parameters(recurse=False),
                        *m.named_buffers(recurse=False)]:
            if not t.is_floating_point():
                continue
            if not train_bn:
                out[pre + name] = t.to(dtype)
            elif name in ("weight", "bias"):
                out[pre + name] = t.to(dtype).float()
    return out


class Bound(nn.Module):
    """``fn(model, ...)`` as a module's forward: what ``functional_call``
    and DistributedDataParallel take, since the losses are functions of the
    model and DDP synchronises only through its wrapped module's forward."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(self.model, *args, **kwargs)


def call_bound(bound: nn.Module, dtype, *args, **kwargs):
    """A :class:`Bound` (or DDP over one) called on :func:`cast_floats`
    of its model (``dtype`` None: on the model itself). The casts' backward
    reaches the f32 masters, where DDP's gradient hooks sit."""
    if dtype is None:
        return bound(*args, **kwargs)
    inner = getattr(bound, "module", bound)  # DDP keeps it as .module
    prefix = "module.model." if inner is not bound else "model."
    cast = {prefix + k: v for k, v in cast_floats(inner.model, dtype).items()}
    return torch.func.functional_call(bound, cast, args, kwargs)


def call_in_dtype(model: nn.Module, dtype, fn, *args, **kwargs):
    """``fn(model, *args, **kwargs)`` on :func:`cast_floats` of ``model``
    (``dtype`` None: on the model itself). Everything ``fn`` computes from
    the model's tensors, the losses included, runs inside the call."""
    if dtype is None:
        return fn(model, *args, **kwargs)
    return call_bound(Bound(model, fn), dtype, *args, **kwargs)


YOLACT_MOMENTUM = 0.9
YOLACT_WEIGHT_DECAY = 5e-4  # yolact config's momentum and decay


def make_yolact_optimizer(model: nn.Module) -> torch.optim.SGD:
    """yolact's SGD: momentum 0.9 and weight decay 5e-4 on every parameter
    (BatchNorm's affine parameters and the biases too), one group whose lr
    :func:`set_lr` sets each iteration; BatchNorm's running statistics are
    buffers, which the optimizer never sees."""
    return torch.optim.SGD(
        [{"params": [p for p in model.parameters() if p.requires_grad],
          "lr_factor": 1.0}], lr=0.0, momentum=YOLACT_MOMENTUM,
        weight_decay=YOLACT_WEIGHT_DECAY)


# yolact's SavePath naming, <cfg>_<epoch>_<iter>.pth
_CKPT_RE = re.compile(r"^(?P<name>.+)_(?P<epoch>\d+)_(?P<iter>\d+)\.pth$")


def ckpt_path(folder: str, cfg_name: str, epoch: int, iteration: int,
              fmt: str = "pth") -> str:
    """``<folder>/<cfg>_<epoch>_<iter>.<fmt>`` (yolact README; "npz" for
    the JAX package's param tree)."""
    return os.path.join(folder, f"{cfg_name}_{epoch}_{iteration}.{fmt}")


def parse_ckpt_iter(path: str) -> int:
    """``--start_iter=-1``: the iteration from a checkpoint's file name."""
    m = _CKPT_RE.match(os.path.basename(path))
    if not m:
        raise ValueError(f"checkpoint name not parseable: {path}")
    return int(m.group("iter"))


def save_yolact_checkpoint(path: str, model: nn.Module) -> None:
    """yolact's checkpoint: the model's state_dict itself, dbolya's keys,
    CPU tensors (upstream ``Yolact.save_weights``);
    ``weights/yolact_map.py::load_yolact_weights`` (or tpuseg's
    ``load_params_ckpt``) reads it back."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(upstream_state_dict(
        {k: v.detach().cpu() for k, v in model.state_dict().items()}), path)
