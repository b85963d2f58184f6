"""Hierarchical wall-clock timers (port of ``tpuseg/utils/timer.py``;
Yolact ``utils/timer.py``), and the program's spans and counters.

- ``with timer.env("name")`` adds the block's time to the stage's total,
  :func:`print_stats` prints the table. CUDA work is asynchronous, so
  ``env`` synchronises the current CUDA device on entry and exit (where
  there is one) to time the device's work too, not its issue.
- ``with timer.span("name")`` marks a stage of the program. It is on only
  while a ``torch.profiler`` records, as decided at its entry: then it is a
  ``record_function`` range named ``tpuseg_torch/<name>``, on the
  profiler's clock with the device's kernels and copies, and its host
  seconds and one call go to the totals. It never synchronises. Off, it is
  one shared no-op context: one flag read, no clock reading.
- ``timer.count("name", n)`` adds ``n`` to a counter, only while a
  profiler records; :func:`counters` reads them.

The timers, spans and counters are the process's own (module state), as
upstream's.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "tpuseg_torch/"  # the record_function names of the spans

_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_counters: dict[str, int] = defaultdict(int)
_disabled: set[str] = set()
_start = time.perf_counter()
_OFF = nullcontext()  # every span while no profiler records


def reset() -> None:
    global _start
    _totals.clear()
    _counts.clear()
    _counters.clear()
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


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        _totals[self.name] += dt
        _counts[self.name] += 1
        return False


def span(name: str):
    """The program's stage ``name``: a profiler range and a timer while a
    ``torch.profiler`` records, else the shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a ``torch.profiler`` records."""
    if _autograd_profiler._is_profiler_enabled:
        _counters[name] += n


def counters() -> dict:
    """The counters since the last :func:`reset`."""
    return dict(_counters)


def total_time() -> float:
    return time.perf_counter() - _start


def print_stats() -> str:
    name_w = max([len(k) for k in _totals] + [len(k) for k in _counters]
                 + [8])
    header = (f" {'Name'.ljust(name_w)} | {'Calls':>7} | {'Total (ms)':>11} "
              f"| {'Avg (ms)':>9}")
    lines = [header, "-" * len(header)]
    for name in sorted(_totals, key=lambda k: -_totals[k]):
        t = _totals[name] * 1000
        c = _counts[name]
        lines.append(f" {name.ljust(name_w)} | {c:>7} | {t:>11.2f} | "
                     f"{t / max(c, 1):>9.3f}")
    if _counters:
        lines += ["", f" {'Counter'.ljust(name_w)} | {'Total':>15}"]
        lines += [f" {k.ljust(name_w)} | {v:>15}"
                  for k, v in sorted(_counters.items())]
    out = "\n".join(lines)
    print(out)
    return out
