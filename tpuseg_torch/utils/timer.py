"""Hierarchical wall-clock timers (port of ``tpuseg/utils/timer.py``;
Yolact ``utils/timer.py``): ``with timer.env("name")`` adds the block's time
to the stage's total, :func:`print_stats` prints the table. CUDA work is
asynchronous, so ``env`` synchronises the current CUDA device on entry and
exit (where there is one) to time the device's work too, not its issue.
The timers are the process's own (module state), as upstream's.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_disabled: set[str] = set()
_start = time.perf_counter()


def reset() -> None:
    global _start
    _totals.clear()
    _counts.clear()
    _start = time.perf_counter()


def disable(name: str) -> None:
    _disabled.add(name)


def enable(name: str) -> None:
    _disabled.discard(name)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def env(name: str):
    if name in _disabled:
        yield
        return
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        _totals[name] += time.perf_counter() - t0
        _counts[name] += 1


def total_time() -> float:
    return time.perf_counter() - _start


def print_stats() -> str:
    name_w = max([len(k) for k in _totals] + [8])
    header = (f" {'Name'.ljust(name_w)} | {'Calls':>7} | {'Total (ms)':>11} "
              f"| {'Avg (ms)':>9}")
    lines = [header, "-" * len(header)]
    for name in sorted(_totals, key=lambda k: -_totals[k]):
        t = _totals[name] * 1000
        c = _counts[name]
        lines.append(f" {name.ljust(name_w)} | {c:>7} | {t:>11.2f} | "
                     f"{t / max(c, 1):>9.3f}")
    out = "\n".join(lines)
    print(out)
    return out
