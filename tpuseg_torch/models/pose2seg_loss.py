"""Pose2Seg's training loss and trainer (port of
``tpuseg/models/pose2seg_loss.py``; Pose2Seg.jittor train.py).

Pixel-wise cross-entropy on the aligned crops: the ground-truth masks are
warped into each person's aligned frame by the same affine as the
features. The whole model trains in train mode (BatchNorm normalises by
the batch's statistics and updates its running statistics, momentum 0.1,
unbiased variance), by SGD with momentum 0.9 and weight decay 5e-4 on
every parameter; the running statistics are buffers, which SGD never sees.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuseg_torch.ops.sampling import affine_align

MOMENTUM = 0.9
WEIGHT_DECAY = 5e-4
BASE_LR = 2e-4


def aligned_ce_loss(logits: torch.Tensor, gt_aligned: torch.Tensor,
                    person_valid: torch.Tensor) -> torch.Tensor:
    """logits [B, P, S, S, 2]; gt_aligned [B, P, S, S] in {0, 1};
    person_valid [B, P] -> the mean over valid people of their mean
    per-pixel cross-entropy."""
    logp = F.log_softmax(logits, -1)
    t = gt_aligned.long()
    ce = -logp.gather(-1, t[..., None])[..., 0]
    per_person = ce.mean(dim=(2, 3))
    w = person_valid.to(ce.dtype)
    return (per_person * w).sum() / w.sum().clamp(min=1.0)


def warp_gt_to_aligned(gt_masks: torch.Tensor, theta: torch.Tensor,
                       align_size: int) -> torch.Tensor:
    """gt_masks [B, P, H, W] float; theta [B, P, 2, 3] -> [B, P, S, S],
    each mask warped by its own person's affine: the people are folded
    into the batch axis (B * P one-channel maps, one sample grid each), so
    no mask is sampled under another person's theta."""
    b, p, h, w = gt_masks.shape
    out = affine_align(gt_masks.reshape(b * p, 1, h, w),
                       theta.reshape(b * p, 1, 2, 3), align_size)
    return out.reshape(b, p, align_size, align_size)


class Pose2SegTrainer:
    """One SGD step of a :class:`~tpuseg_torch.models.pose2seg.Pose2Seg`
    in train mode on aligned ground truth, at upstream's constant learning
    rate."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.cfg = model.cfg
        self.optimizer = torch.optim.SGD(
            model.parameters(), lr=BASE_LR, momentum=MOMENTUM,
            weight_decay=WEIGHT_DECAY)
        # every parameter steps, as the JAX package's SGD steps every leaf:
        # smooth1 and smooth2, which P2 does not use, get a zero gradient
        # and decay (torch's SGD would skip a parameter without gradient)
        for p in model.parameters():
            p.grad = torch.zeros_like(p)

    def loss(self, images, theta, valid, gt_aligned, skel=None):
        """The training forward: images [B, 3, S, S], theta [B, P, 2, 3],
        valid [B, P], gt_aligned [B, P, O, O], skel [B, P, O, O, 55] (or
        None without ``cat_skeleton``) -> the loss, the model in train
        mode."""
        if skel is None and self.cfg.cat_skeleton:
            # the skeleton channels zeroed would train a segnet that never
            # learns the skeleton pathway
            raise ValueError("cfg.cat_skeleton is on: pass skel features to "
                             "train_step")
        self.model.train()
        logits = self.model.heads(self.model.backbone(images), theta, skel)
        return aligned_ce_loss(logits, gt_aligned, valid)

    def train_step(self, images, theta, valid, gt_aligned,
                   skel=None) -> torch.Tensor:
        """One step -> the loss before it (detached)."""
        loss = self.loss(images, theta, valid, gt_aligned, skel)
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        self.optimizer.step()
        return loss.detach()
