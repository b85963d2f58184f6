"""Profiling helpers (port of ``tpuseg/utils/profiler.py``): a device trace
through ``torch.profiler`` and a steady-state throughput measure. While a
trace records, the program's spans (``utils/timer.py``) are ranges
``tpuseg_torch/<stage>`` in it, over the device's rows.

CUDA calls return before the device finishes, so :func:`measure_throughput`
synchronises the devices of the tensors ``fn`` returns before it reads the
clock (``jax.block_until_ready`` in tpuseg).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from tpuseg_torch.utils import timer


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of what runs inside: ``with trace(dir): run()``.
    The CPU always, CUDA when a card is there; written to
    ``<log_dir>/trace.json`` (Perfetto / chrome://tracing) on exit, and the
    table of the spans and counters that ran inside printed."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    timer.reset()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"trace written to {path}")
    timer.print_stats()


def _devices(tree, out: set) -> set:
    if torch.is_tensor(tree):
        out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _devices(v, out)
    return out


def block_until_ready(tree):
    """Wait for the work that produces ``tree``'s tensors: synchronise
    each CUDA device they lie on. -> ``tree``."""
    for dev in _devices(tree, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return tree


def measure_throughput(fn, *args, iters: int = 20, warmup: int = 3,
                       items_per_call: int = 1) -> tuple:
    """Steady-state wall clock of ``fn(*args)`` -> (items/s, ms per call):
    ``warmup`` calls, then ``iters`` timed calls, each waited for."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        block_until_ready(fn(*args))
    dt = (time.perf_counter() - t0) / iters
    return items_per_call / dt, dt * 1e3
