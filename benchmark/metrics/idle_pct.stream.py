"""Share of the traced window in which no operation ran on the device,
from the union of the trace's device intervals."""
from benchmark.common import trace


def read(ctx):
    ev = ctx["events"]
    lo = min(e.start_ns for e in ev)
    hi = max(e.end_ns for e in ev)
    return 100.0 * (1.0 - trace.busy_ns(ev, lo, hi) / (hi - lo))
