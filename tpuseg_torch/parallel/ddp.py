"""Data-parallel training with tpuseg's global-batch semantics.

tpuseg trains one program over the chips: its loss normalisers count over
the whole batch, its train-mode BatchNorm takes the whole batch's
statistics, and each image draws what it would draw on one device
(``tests/test_parallel.py``). The port trains one process per GPU under
DistributedDataParallel, which averages the ranks' gradients; the helpers
here restore the global semantics on top of it:

- :func:`denominator`: a loss divides its local sum by the global count
  over the world size, so that DDP's mean of the ranks' gradients is the
  gradient of the global loss;
- :func:`global_rows`: a rank's rows of a draw made for the global batch;
- :func:`global_kth_largest`: a batch-wide threshold over all ranks;
- :func:`mean_over_ranks`: the losses as the global batch's, for logging;
- ``sync_bn.py``: BatchNorm's statistics over the global batch.

Every collective is an ``all_reduce`` of a tensor, which gloo also runs on
CUDA tensors (two ranks on one card). Without a process group (or a
:class:`~tpuseg_torch.parallel.mesh.ThreadGroup`) each helper is the
identity, so one process computes what it always did, bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from tpuseg_torch.parallel.mesh import thread_group, world


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor, ``t`` unchanged, on
    its device). NCCL reduces CUDA tensors only: a CPU tensor (a count made
    from a shape) goes through this rank's card."""
    group = thread_group()
    if group is not None:
        return group.all_reduce(t)
    dev = t.device
    if dev.type == "cpu" and dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    out = t.to(dev, copy=True)
    dist.all_reduce(out)
    return out.to(t.device)


def global_count(t: torch.Tensor) -> torch.Tensor:
    """A count summed over the ranks, outside autograd; ``t`` itself
    without a group."""
    if world()[1] == 1:
        return t
    with torch.no_grad():
        return all_reduce(t.detach())


def denominator(count, floor=None):
    """The divisor of a rank's local sum: the global ``count`` (at least
    ``floor``) over the world size. With one rank, ``count`` clamped as
    the single-process loss does, so nothing changes bit for bit."""
    ws = world()[1]
    if ws == 1:
        return count if floor is None else count.clamp(min=floor)
    if not torch.is_tensor(count):
        count = torch.tensor(count)
    total = global_count(count)
    if floor is not None:
        total = total.clamp(min=floor)
    return total / ws


def global_rows(draw, b: int):
    """``draw(B)`` -> this rank's ``b`` rows of a draw made for the global
    batch ``B = b * world size`` (a list or a tensor with rows first): every
    rank draws the same global rows from one seed and keeps its own, so an
    image draws what it draws in one process."""
    rank, ws = world()
    rows = draw(b * ws)
    return rows if ws == 1 else rows[rank * b:(rank + 1) * b]


def global_kth_largest(values: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest of ``values`` (1-D) over every rank's values
    together (k capped at their number): each rank's top k, gathered by a
    zero-padded all-reduce."""
    rank, ws = world()
    if ws == 1:
        return torch.topk(values, min(k, values.numel())).values[-1]
    kl = min(k, values.numel())
    rows = torch.zeros((ws, k + 1), dtype=torch.float64,
                       device=values.device)
    rows[rank, :k] = float("-inf")
    rows[rank, :kl] = torch.topk(values, kl).values.double()
    rows[rank, k] = values.numel()
    rows = all_reduce(rows)
    n = int(rows[:, k].sum())
    top = torch.topk(rows[:, :k].reshape(-1), min(k, n)).values
    return top[-1].to(values.dtype)


def mean_over_ranks(losses: dict) -> dict:
    """Each rank's losses (its local sums over the global denominators)
    -> their mean over the ranks: the global batch's losses, the same on
    every rank. Detached; the input itself with one rank."""
    if world()[1] == 1:
        return losses
    keys = list(losses)
    with torch.no_grad():
        vals = torch.stack([losses[k].detach().double() for k in keys])
        vals = all_reduce(vals) / world()[1]
    return {k: v.to(losses[k].dtype) for k, v in zip(keys, vals)}


def wrap(module: torch.nn.Module, device,
         find_unused_parameters: bool = False) -> DistributedDataParallel:
    """DDP over ``module``, on the current process group: ``device_ids``
    on CUDA, none on the CPU. Buffers are not broadcast at each forward:
    a frozen BatchNorm's never change, and a synchronised one's running
    statistics are updated from the same global statistics on every rank.
    ``find_unused_parameters``: whether the loss leaves a trainable
    parameter out of the graph (YOLACT++'s FastMaskIoUNet under a loss
    without its term)."""
    device = torch.device(device)
    return DistributedDataParallel(
        module, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False,
        find_unused_parameters=find_unused_parameters)
