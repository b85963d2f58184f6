"""Reading a ``torch.profiler`` trace of the window: the device's busy
time as the union of its operations' intervals, the idle gaps and what the
host was doing in each, and the device time by operation name.

``tpuseg_torch/tools/step_profile.py`` took the device's busy time as the
sum of its kernels' times, which counts twice where two streams overlap
(``data/prefetch.py`` uploads on a side stream); here overlapping
intervals are merged first. Events are read as plain tuples, so the
arithmetic is tested on synthetic traces without a card.
"""
from __future__ import annotations

from typing import NamedTuple

# the profiler's activity types of work that runs on the device
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench/"  # record_function names of the harness's spans


class Event(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    on_device: bool
    is_span: bool  # a harness span (a host-side user annotation)


def events_of(prof) -> list:
    """The profiler's events as :class:`Event` tuples."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        on_device = (kind in DEVICE_ACTIVITIES if kind else
                     "CUDA" in str(e.device_type())
                     and not e.is_user_annotation())
        name = e.name()
        out.append(Event(name, int(e.start_ns()), int(e.end_ns()), on_device,
                         not on_device and name.startswith(SPAN_PREFIX)))
    return out


def merge(intervals) -> list:
    """Sorted, disjoint [start, end) intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_ns(events, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) in which some device operation ran."""
    ivs = merge((max(e.start_ns, lo), min(e.end_ns, hi)) for e in events
                if e.on_device and e.end_ns > lo and e.start_ns < hi)
    return sum(e - s for s, e in ivs)


def idle_gaps(events, lo: int, hi: int) -> list:
    """The [start, end) stretches of [lo, hi) with no device operation."""
    gaps, t = [], lo
    for s, e in merge((e.start_ns, e.end_ns) for e in events if e.on_device):
        if s > t and t < hi:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def host_label(events, t: int) -> str:
    """What the host was doing at ``t``: the innermost harness span open
    then, else the shortest host operation open then, else 'none'."""
    open_ = [e for e in events if not e.on_device and e.start_ns <= t < e.end_ns]
    spans = [e for e in open_ if e.is_span]
    pick = spans or open_
    if not pick:
        return "none"
    return min(pick, key=lambda e: e.end_ns - e.start_ns).name


def longest_gaps(events, lo: int, hi: int, top: int = 10) -> list:
    """[[label, seconds]]: the ``top`` longest idle gaps, each named by
    :func:`host_label` at its middle."""
    gaps = sorted(idle_gaps(events, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return [[host_label(events, (s + e) // 2), (e - s) / 1e9] for s, e in gaps]


def device_time_by_name(events) -> dict:
    """Seconds of device time per operation name (each operation's own
    interval; overlapping operations each count theirs)."""
    ns = {}
    for e in events:
        if e.on_device:
            ns[e.name] = ns.get(e.name, 0) + e.end_ns - e.start_ns
    return {k: v / 1e9 for k, v in ns.items()}


def top_ops(events, top: int = 10) -> list:
    """[[name, seconds]] of the ``top`` device operations by time."""
    by = device_time_by_name(events)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def kernel_seconds(events, names) -> float:
    """Device seconds of the operations whose name contains one of
    ``names`` (the port's kernels are named in ``csrc/*.cu``)."""
    return sum(e.end_ns - e.start_ns for e in events
               if e.on_device and any(n in e.name for n in names)) / 1e9
