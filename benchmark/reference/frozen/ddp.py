"""The single-process identities of the port's ``parallel/ddp.py`` helpers
that the frozen models call: one process, no group, so each returns what
the single-process loss computes."""
from __future__ import annotations

import torch


def denominator(count, floor=None):
    return count if floor is None else count.clamp(min=floor)


def global_rows(draw, b: int):
    return draw(b)


def global_kth_largest(values: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest of ``values`` (1-D), k capped at their number."""
    return torch.topk(values, min(k, values.numel())).values[-1]
