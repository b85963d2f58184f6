"""BatchNorm over the global batch of a data-parallel step.

tpuseg's train-mode BatchNorm under a sharded batch takes its statistics
over the whole batch (XLA turns the means into collectives). Here each
rank's :class:`SyncBatchNorm2d` all-reduces, per channel, its count, mean
and centred sum of squares (combined in rank order, Chan's parallel
formula) in the forward, and the sums of dy and dy * x̂ in the backward.
Statistics are taken in f32 (or f64) whatever the input's dtype, as
``engine/trainer.py::cast_floats`` expects of a bf16 step; the running
statistics move by momentum 0.1 towards the global mean and the unbiased
global variance (tpuseg's ``bn_apply_stats``). ``torch.nn.SyncBatchNorm``
is not used: it refuses CPU tensors and gathers with ``all_gather``, which
gloo does not run on CUDA tensors.
"""
from __future__ import annotations

import torch
from torch import nn

from tpuseg_torch.parallel.ddp import all_reduce
from tpuseg_torch.parallel.mesh import world


def _channels(t: torch.Tensor) -> torch.Tensor:
    return t[None, :, None, None]


class _SyncBatchNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, bn):
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        c = x.shape[1]
        rank, ws = world()
        mean_l = xf.mean((0, 2, 3))
        rows = torch.zeros((ws, 2 * c + 1), dtype=acc, device=x.device)
        rows[rank, :c] = mean_l
        rows[rank, c:2 * c] = (xf - _channels(mean_l)).square().sum((0, 2, 3))
        rows[rank, 2 * c] = x.numel() // c
        rows = all_reduce(rows)
        counts = rows[:, 2 * c:]
        n = counts.sum()
        mean = (rows[:, :c] * counts).sum(0) / n
        m2 = (rows[:, c:2 * c] + counts * (rows[:, :c] - mean).square()).sum(0)
        var = m2 / n
        invstd = torch.rsqrt(var + bn.eps)
        xhat = (xf - _channels(mean)) * _channels(invstd)
        y = xhat * _channels(weight.to(acc)) + _channels(bias.to(acc))
        with torch.no_grad():
            m = bn.momentum
            rm, rv = bn.running_mean, bn.running_var
            rm.mul_(1 - m).add_(m * mean.to(rm.dtype))
            rv.mul_(1 - m).add_(m * (m2 / (n - 1)).to(rv.dtype))
        ctx.save_for_backward(x, weight, mean, invstd, n)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        acc = mean.dtype
        c = x.shape[1]
        xhat = (x.to(acc) - _channels(mean)) * _channels(invstd)
        dyf = dy.to(acc)
        dbias = dyf.sum((0, 2, 3))
        dweight = (dyf * xhat).sum((0, 2, 3))
        sums = all_reduce(torch.cat([dbias, dweight]))
        dx = _channels(weight.to(acc) * invstd) * (
            dyf - _channels(sums[:c] / n) - xhat * _channels(sums[c:] / n))
        return (dx.to(x.dtype), dweight.to(weight.dtype),
                dbias.to(weight.dtype), None)


class SyncBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (the same parameters, buffers and state_dict
    keys) whose train mode under more than one rank takes the global
    batch's statistics; otherwise exactly its base class's forward."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or world()[1] == 1:
            return super().forward(x)
        if not (self.affine and self.track_running_stats
                and self.momentum is not None):
            raise ValueError("SyncBatchNorm2d needs affine parameters, "
                             "running statistics and a momentum")
        self.num_batches_tracked.add_(1)
        return _SyncBatchNorm.apply(x, self.weight, self.bias, self)


_SYNCED = {nn.BatchNorm2d: SyncBatchNorm2d}


def _synced(cls: type) -> type:
    """The synchronised class of a BatchNorm class: ``SyncBatchNorm2d``,
    or for a subclass (DarkNet's, whose eval mode folds its statistics) a
    class of both, so that its own eval forward stays."""
    if cls not in _SYNCED:
        _SYNCED[cls] = type(f"Sync{cls.__name__}", (SyncBatchNorm2d, cls), {})
    return _SYNCED[cls]


def convert_sync_bn(model: nn.Module) -> nn.Module:
    """Make every ``nn.BatchNorm2d`` of ``model`` synchronised, in place
    (same objects, parameters and buffers; ``isinstance`` checks hold)."""
    for m in model.modules():
        if (isinstance(m, nn.BatchNorm2d)
                and not isinstance(m, SyncBatchNorm2d)):
            m.__class__ = _synced(type(m))
    return model
