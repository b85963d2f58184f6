"""When a stream's requests are sent, from the mix's ``arrivals``:

- ``{"process": "closed"}``: one client, which sends the next request as
  soon as the result of the one before is back (a camera demo or a video
  file run through the predictor). A request's latency runs from its send.
- ``{"process": "open", "rate_hz": r, "gaps": "fixed" | "exponential",
  "burst": n, "seed": s}``: requests due at fixed times whatever the state
  of the ones before, ``n`` at once, bursts ``n / r`` seconds apart on
  average. Exponential gaps are drawn once from the mix's own ``seed`` and
  put in an order drawn from the run's seed, so that every run offers the
  same set of gaps. A request's latency runs from when it was due.
"""
from __future__ import annotations

import numpy as np


def is_closed(arrivals: dict) -> bool:
    if arrivals["process"] not in ("closed", "open"):
        raise ValueError(f"unknown arrival process {arrivals['process']!r}")
    return arrivals["process"] == "closed"


def open_due(arrivals: dict, seed: int, seconds: float) -> np.ndarray:
    """Due times (seconds from the window's start) of an open stream's
    requests in a window of ``seconds``."""
    burst = int(arrivals.get("burst", 1))
    mean_gap = burst / float(arrivals["rate_hz"])
    n = int(np.ceil(seconds / mean_gap)) + 1
    if arrivals["gaps"] == "fixed":
        gaps = np.full(n, mean_gap)
    elif arrivals["gaps"] == "exponential":
        gaps = np.random.default_rng(arrivals["seed"]).exponential(mean_gap, n)
        gaps *= n * mean_gap / gaps.sum()  # the same mean rate every run
        gaps = np.random.default_rng(seed).permutation(gaps)
    else:
        raise ValueError(f"unknown gaps {arrivals['gaps']!r}")
    starts = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    due = np.repeat(starts, burst)
    return due[due < seconds]
