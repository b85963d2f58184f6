"""Shared loss ops (port of ``tpuseg/ops/losses.py``).

:func:`sigmoid_focal_loss` computes what upstream's SigmoidFocalLoss CUDA op
computes (``csrc/cuda/SigmoidFocalLoss_cuda.cu``), elementwise in plain
torch: the JAX package leaves it to XLA and has no Pallas kernel for it.
"""
from __future__ import annotations

import torch


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25
                       ) -> torch.Tensor:
    """Per-anchor, per-class focal loss: logits [N, C] (no background
    column), targets [N] int, 0 background, 1..C a class, < 0 ignored ->
    [N, C]. Class c is positive iff targets == c; a background row drives
    every class negative; an ignored row contributes zero."""
    c = logits.shape[1]
    cls_ids = torch.arange(1, c + 1, device=logits.device)
    t = (targets[:, None] == cls_ids[None, :]).to(logits.dtype)
    valid = (targets >= 0)[:, None].to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * t
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * t + (1 - p) * (1 - t)
    loss = ce * (1 - p_t) ** gamma
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    return loss * alpha_t * valid
