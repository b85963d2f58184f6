"""ViTDet's attention in a traced run: the device time of the kernels
inside the program's ``vit.window_attn`` and ``vit.global_attn`` ranges,
and the least time of those calls from their shapes.

The device time is read from each range's device copy (the profiler's
``gpu_user_annotation`` over the kernels issued inside the range, which
``common/program.py`` leaves aside): the device operations that lie wholly
inside a copy. A trace without such copies (a CPU run, or a program without
the ranges) gives nothing.

The least time of one call, attention with decomposed relative positions
over n = (images x windows x heads) grids of N = K_h x K_w tokens of C
channels, is ``roofline.bound`` of what any implementation must do:

- operations: the scores q k^T (2 N N C a grid), the two relative-term
  products (2 N (K_h + K_w) C) and their adds into each score (2 N N), the
  softmax (SOFTMAX_OPS_PER_SCORE a score: the row's max, the subtraction,
  the exponential, the row's sum, the division) and P v (2 N N C);
- bytes: q, k and v read and the output written (4 n N C values), and the
  two tables ((2 K_h - 1 + 2 K_w - 1) C values), with no N x N scores.

A call's shapes come from the run's weights (each block's tables give its
K and C, its qkv layer the heads) and the program's counters: a windowed
call's windows from ``vit.window_tokens``, a global call's images from
``predictor.images`` over the ``predictor.run`` ranges.
"""
from __future__ import annotations

import bisect
import re

from benchmark.common import program, roofline

SOFTMAX_OPS_PER_SCORE = 5
SPANS = ("vit.window_attn", "vit.global_attn")


def attention_ops(n: int, kh: int, kw: int, c: int) -> float:
    """Operations of one call over n grids of kh x kw tokens."""
    t = kh * kw
    return n * (2 * t * t * c + 2 * t * (kh + kw) * c + 2 * t * t
                + SOFTMAX_OPS_PER_SCORE * t * t + 2 * t * t * c)


def attention_bytes(n: int, kh: int, kw: int, c: int, itemsize: int) -> float:
    """Bytes one call must move: q, k, v, the output and the tables."""
    return itemsize * (4 * n * kh * kw * c + (2 * kh - 1 + 2 * kw - 1) * c)


def attention_bound(n: int, kh: int, kw: int, c: int, itemsize: int) -> float:
    return roofline.bound(attention_bytes(n, kh, kw, c, itemsize),
                          attention_ops(n, kh, kw, c))


def _rows(ctx) -> list:
    """The program's ranges of the traced run, read once a run."""
    if "program_rows" not in ctx:
        prof = ctx.get("prof")
        ctx["program_rows"] = program.ranges_of(prof) if prof else []
    return ctx["program_rows"]


def device_copies(ctx, span: str) -> list:
    """[(start_ns, end_ns)] of the device copies of the program's ``span``
    ranges, sorted."""
    if "program_device_ranges" not in ctx:
        out = {}
        for r in _rows(ctx):
            if not r.on_host:
                out.setdefault(r.name, []).append((r.start_ns, r.end_ns))
        ctx["program_device_ranges"] = {k: sorted(v) for k, v in out.items()}
    return ctx["program_device_ranges"].get(span, [])


def device_ns_inside(events, ranges) -> int:
    """Nanoseconds of the device operations lying wholly inside one of
    ``ranges`` (sorted, disjoint)."""
    ops = sorted((e.start_ns, e.end_ns) for e in events if e.on_device)
    starts = [s for s, _ in ops]
    ns = 0
    for lo, hi in ranges:
        for s, e in ops[bisect.bisect_left(starts, lo):
                        bisect.bisect_right(starts, hi)]:
            if e <= hi:
                ns += e - s
    return ns


def device_ms_per_request(ctx, span: str) -> float | None:
    """Device milliseconds a request of the kernels inside ``span``."""
    ranges = device_copies(ctx, span)
    if not ranges or not ctx.get("items"):
        return None
    return device_ns_inside(ctx["events"], ranges) / 1e6 / ctx["items"]


def block_shapes(state: dict) -> list:
    """[(K_h, K_w, C, heads)] of each block, from its tables and qkv."""
    out = []
    for key, table in sorted(state.items()):
        m = re.fullmatch(r"(.*\.blocks\.\d+\.attn)\.rel_pos_h", key)
        if m:
            kw = state[m.group(1) + ".rel_pos_w"].shape[0]
            embed = state[m.group(1) + ".qkv.weight"].shape[1]
            c = table.shape[1]
            out.append(((table.shape[0] + 1) // 2, (kw + 1) // 2, c,
                        embed // c))
    return out


def roofline_pct(ctx) -> float | None:
    """100 x the least time of the window's attention calls over the
    device time of the kernels inside their ranges."""
    ranges = {s: device_copies(ctx, s) for s in SPANS}
    spent = sum(device_ns_inside(ctx["events"], r) for r in ranges.values())
    host = program.host_ranges(_rows(ctx))
    counts = program.counters()
    forwards = len(host.get("predictor.run", []))
    shapes = block_shapes(ctx.get("state_host", {}))
    if spent <= 0 or not shapes or not forwards:
        return None
    grid = max(shapes)  # the global blocks' tables span the whole grid
    window = min(shapes)
    itemsize = 4  # the program's float32
    least = 0.0
    n_global = len(host.get("vit.global_attn", []))
    if n_global:
        kh, kw, c, heads = grid
        images = counts.get("predictor.images", 0) / forwards
        least += n_global * attention_bound(int(images * heads), kh, kw, c,
                                            itemsize)
    n_window = len(host.get("vit.window_attn", []))
    if n_window:
        kh, kw, c, heads = window
        windows = counts.get("vit.window_tokens", 0) / (kh * kw * n_window)
        least += n_window * attention_bound(int(windows * heads), kh, kw, c,
                                            itemsize)
    return 100.0 * least / (spent / 1e9)
