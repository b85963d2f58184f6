"""The program's own spans and counters in a traced run
(``tpuseg_torch/utils/timer.py``): its ``record_function`` ranges named
``tpuseg_torch/<span>``, read from the profiler's events, each stage
grouped by the iteration or request range that holds it; the device's idle
time under a span; and the program's counters.

On a card the profiler gives each range twice: on the host (device type
CPU), and as a ``gpu_user_annotation`` over the kernels issued inside it
(device type CUDA), which ``common/trace.py::events_of`` keeps as a host
event too. Only the host's copy is read here. A program without the
spans or the counters (an older tree) leaves every reader here with
nothing to read: they return None.
"""
from __future__ import annotations

import bisect
from typing import NamedTuple

from benchmark.common import trace
from benchmark.common.stats import median

PREFIX = "tpuseg_torch/"


class Range(NamedTuple):
    name: str  # the span's name, without the prefix
    start_ns: int
    end_ns: int
    on_host: bool


def ranges_of(prof) -> list:
    """The profiler's events of the program's spans as :class:`Range`."""
    return [Range(e.name()[len(PREFIX):], int(e.start_ns()), int(e.end_ns()),
                  "CPU" in str(e.device_type()))
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(PREFIX)]


def host_ranges(rows) -> dict:
    """span name -> its host ranges [(start_ns, end_ns)], sorted."""
    out = {}
    for r in rows:
        if r.on_host:
            out.setdefault(r.name, []).append((r.start_ns, r.end_ns))
    return {k: sorted(v) for k, v in out.items()}


def per_parent(spans: dict, parent: str, stage: str, lo: int, hi: int) -> list:
    """Seconds of ``stage`` summed inside each ``parent`` range that lies
    wholly in [lo, hi] (0 where a parent holds none)."""
    kids = spans.get(stage, [])
    starts = [s for s, _ in kids]
    out = []
    for p0, p1 in spans.get(parent, []):
        if p0 < lo or p1 > hi:
            continue
        ns = 0
        for s, e in kids[bisect.bisect_left(starts, p0):
                        bisect.bisect_right(starts, p1)]:
            if e <= p1:
                ns += e - s
        out.append(ns / 1e9)
    return out


def overlap_ns(a, b) -> int:
    """Nanoseconds in both of two lists of sorted, disjoint intervals."""
    i = j = n = 0
    while i < len(a) and j < len(b):
        n += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return n


def idle_share_under(events, spans: dict, stage: str) -> float | None:
    """Share (0..1) of the trace's device-idle time that falls inside a
    ``stage`` range, or None where there is no such range or no idle time."""
    if not spans.get(stage) or not events:
        return None
    lo = min(e.start_ns for e in events)
    hi = max(e.end_ns for e in events)
    gaps = trace.idle_gaps(events, lo, hi)
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    return overlap_ns(gaps, trace.merge(spans[stage])) / idle


def _spans(ctx) -> dict:
    """The traced run's host ranges of the program, read once a run."""
    if "program_spans" not in ctx:
        prof = ctx.get("prof")
        ctx["program_spans"] = host_ranges(ranges_of(prof)) if prof else {}
    return ctx["program_spans"]


def stage_ms(ctx, parent: str, stage: str) -> float | None:
    """Median over the run's ``parent`` ranges of the milliseconds of
    ``stage`` inside each; None where the program has no ``parent``."""
    ev = ctx["events"]
    lo = min(e.start_ns for e in ev)
    hi = max(e.end_ns for e in ev)
    per = per_parent(_spans(ctx), parent, stage, lo, hi)
    return 1e3 * median(per) if per else None


def idle_pct_under(ctx, stage: str) -> float | None:
    share = idle_share_under(ctx["events"], _spans(ctx), stage)
    return None if share is None else 100.0 * share


def counters() -> dict:
    """The program's counters (``timer.counters()``), {} where it has none."""
    from tpuseg_torch.utils import timer

    read = getattr(timer, "counters", None)
    return read() if read is not None else {}


def counter_ratio(num: str, den: str, scale: float = 1.0) -> float | None:
    """scale x counter ``num`` / counter ``den``, both counted at one place
    in the program; None where ``den`` was not counted."""
    c = counters()
    if not c.get(den):
        return None
    return scale * c.get(num, 0) / c[den]
