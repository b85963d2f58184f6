"""The stream window: requests of one host frame each, served one at a
time through the port's per-image entry point, sent as the mix's
``arrivals`` say (``common/arrivals.py``: one client in a closed loop, or
an open stream), each timed to when its host result is back. No request
starts after the window's ``seconds``; in an open stream one that was due
by then and had not started is counted as unserved. Frames cycle in an
order drawn from the seed; a sample of them, drawn from the seed, keeps
its first result in the window for the check. End-to-end metrics:
``setup_s``, ``stream_img_s`` (requests completed over the window) and
``stream_p95_ms`` (the 95th percentile of every request's latency)."""
from __future__ import annotations

import time

import numpy as np
from tpuseg_torch import kernels

from benchmark.common import arrivals as A
from benchmark.common import card, frames as F
from benchmark.common.spans import Spans
from benchmark.common.stats import median, percentile

WARM_REQUESTS = 3


def run(cfg_mod, sizes: dict, mix: dict, seed: int,
        seconds: float, trace: bool, dev, t_start: float,
        dtype=None) -> dict:
    marks = [("start", time.perf_counter())]
    h, w = mix["frame_hw"]
    imgs = F.frames(seed, mix["frames"], h, w, dev)
    marks.append(("frames", time.perf_counter()))
    state = cfg_mod.serve_state(sizes, seed, dev, imgs)
    state_host = {k: v.detach().cpu() for k, v in state.items()}
    pred = cfg_mod.make_predictor(sizes, state, dev, dtype)
    del state
    marks.append(("weights, calibration and predictor", time.perf_counter()))
    rng = np.random.default_rng(seed)
    order = rng.permutation(mix["frames"])
    sample = set(int(i) for i in rng.choice(mix["frames"], mix["sample"],
                                            replace=False))
    closed = A.is_closed(mix["arrivals"])
    due_at = None if closed else A.open_due(mix["arrivals"], seed, seconds)
    for j in range(WARM_REQUESTS):
        cfg_mod.request(pred, imgs[order[j]])
    card.sync(dev)
    flops = cfg_mod.flops_per_request(pred, imgs[order[0]]) if trace else None
    marks.append((f"{WARM_REQUESTS} warm-up requests", time.perf_counter()))
    spans = Spans(sync_ok=trace and dev.type == "cuda")
    calls, counts, prof, undo_calls = {}, {}, None, None
    if trace:
        from benchmark.common import kernel_calls

        for name, (attr, sync) in cfg_mod.STREAM_SPANS.items():
            spans.wrap(pred, attr, name, sync)
        undo_calls = kernel_calls.record(calls, counts)
        prof = card.profiler(dev)
        prof.__enter__()
    launches0 = kernels.launch_counts()
    lat, late, kept, sent = [], [], {}, []
    t0 = time.perf_counter()
    i = 0
    try:
        while True:
            now = time.perf_counter()
            if closed:
                due = now
            elif i < len(due_at):
                due = t0 + due_at[i]
            else:
                break
            if now >= t0 + seconds:
                break
            if now < due:
                with spans.span("wait"):
                    time.sleep(due - now)
            late.append(max(0.0, time.perf_counter() - due))
            f = int(order[i % len(order)])
            spans.item = i
            with spans.span("request"):
                out = cfg_mod.request(pred, imgs[f])
            lat.append(time.perf_counter() - due)
            sent.append(due)
            if f in sample and f not in kept:
                kept[f] = out
            i += 1
        card.sync(dev)
        t1 = time.perf_counter()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if undo_calls is not None:
            undo_calls()
        spans.restore()
    unserved = 0 if closed else len(due_at) - len(lat)
    launches = {k: v - launches0[k] for k, v in kernels.launch_counts().items()}
    peak = card.memory_peak(dev)
    del pred
    card.free(dev)
    marks.append(("window", t1))
    setup_log = ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                          in zip([("", t_start)] + marks, marks[:-1]))
    how = ("one client, closed loop" if closed
           else f"open, {mix['arrivals']}")
    return {
        "setup_s": t0 - t_start, "window_s": t1 - t0,
        "e2e": {"setup_s": t0 - t_start,
                "stream_img_s": len(lat) / (t1 - t0),
                "stream_p95_ms": 1e3 * percentile(lat, 95)},
        "item_name": "requests", "t0": t0, "t1": t1, "items": len(lat),
        "latencies": lat, "peak": peak,
        "spans": spans, "prof": prof, "calls": calls, "counts": counts,
        "flops_per_item": flops, "launches": launches,
        "state_host": state_host, "frames": imgs, "kept": kept, "failed": 0,
        "log": [f"set-up: {setup_log}",
                f"{len(lat)} requests ({how}): latency median "
                f"{1e3 * percentile(lat, 50):.2f} ms, p95 "
                f"{1e3 * percentile(lat, 95):.2f} ms, max "
                f"{1e3 * max(lat):.2f} ms; sent late by {1e3 * max(late):.2f} "
                f"ms at most, {1e3 * sum(late) / len(late):.3f} ms on average; "
                f"{unserved} due in the window and not started",
                "median latency ms a 5 s of the window: " + str([
                    round(1e3 * median(part), 2) if part else None
                    for part in ([x for x, d in zip(lat, sent)
                                  if 5 * j <= d - t0 < 5 * (j + 1)]
                                 for j in range(int(seconds // 5)))])],
    }


def check(ref_mod, run: dict, sizes: dict, mix: dict, seed: int, dev) -> tuple:
    """The reference on each kept frame, then the numbers compared."""
    from benchmark.common import check as C

    ids = sorted(run["kept"])
    ref = ref_mod.requests(sizes, run["state_host"],
                           [run["frames"][f] for f in ids], dev)
    return C.detection_numbers([run["kept"][f] for f in ids], ref)
