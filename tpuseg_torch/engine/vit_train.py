"""ViT finetuning (port of ``tpuseg/engine/vit_train.py``; ViT.jittor
train.py): cross-entropy, optionally label-smoothed, SGD with momentum 0.9
and weight decay 1e-4 on every parameter, a warm-up then cosine schedule.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.engine.classify import build_vit
from tpuseg_torch.nn import vit as vit_nn

MOMENTUM = 0.9
WEIGHT_DECAY = 1e-4


def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 500):
    """lr(it): linear warm-up from 0 over ``warmup`` steps, then a cosine
    from ``base_lr`` to 0 at ``total_steps``, in f32 as the JAX
    schedule computes it."""
    f32 = np.float32

    def lr(it) -> float:
        it = f32(it)
        if it < warmup:
            return float(f32(base_lr) * it / f32(max(warmup, 1)))
        prog = np.clip((it - f32(warmup)) / f32(max(total_steps - warmup, 1)),
                       f32(0), f32(1))
        return float(f32(base_lr) * f32(0.5)
                     * (f32(1) + np.cos(f32(np.pi) * prog)))

    return lr


class ViTTrainer:
    """One SGD step of a ViT on ``device``: the model built from
    ``state_dict`` or random weights (seed 0)."""

    def __init__(self, cfg: vit_nn.ViTConfig, lr_fn=None,
                 label_smoothing: float = 0.0,
                 state_dict: dict | None = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but CUDA is unavailable")
        self.cfg = cfg
        self.lr_fn = lr_fn or cosine_schedule(3e-2, 10000)
        self.label_smoothing = label_smoothing
        self.model = build_vit(cfg, state_dict).to(self.device)
        self.optimizer = torch.optim.SGD(
            self.model.parameters(), lr=0.0, momentum=MOMENTUM,
            weight_decay=WEIGHT_DECAY)

    def loss(self, images: torch.Tensor, labels: torch.Tensor) -> tuple:
        """images [B, 3, H, W] normalised, labels [B] -> (the mean loss,
        the accuracy), the model in train mode."""
        self.model.train()
        logits = self.model(images.to(self.device))
        labels = labels.to(self.device).long()
        logp = F.log_softmax(logits, -1)
        if self.label_smoothing > 0:
            nc, s = self.cfg.num_classes, self.label_smoothing
            t = F.one_hot(labels, nc).to(logp.dtype) * (1 - s) + s / nc
            loss = -(t * logp).sum(-1)
        else:
            loss = -logp.gather(-1, labels[:, None])[:, 0]
        acc = (logits.argmax(-1) == labels).to(logits.dtype).mean()
        return loss.mean(), acc

    def train_step(self, images: torch.Tensor, labels: torch.Tensor,
                   iteration: int) -> dict:
        """One step at ``lr_fn(iteration)`` -> {loss, acc} before it
        (detached)."""
        loss, acc = self.loss(images, labels)
        for group in self.optimizer.param_groups:
            group["lr"] = float(self.lr_fn(iteration))
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach(), "acc": acc.detach()}
