"""The detectron solver (port of the parts of ``tpuseg/engine/trainer.py``
that the Mask R-CNN training loop uses): WarmupMultiStepLR,
maskrcnn-benchmark's SGD parameter groups, and the checkpoint writer.

``torch.optim.SGD`` (momentum 0.9, no dampening) computes what the JAX
``sgd_update`` computes: buf = m * buf + (grad + wd * p); p -= lr * buf,
its first buffer being the first gradient, as from a zeroed one.
"""
from __future__ import annotations

import os

import torch
from torch import nn


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
