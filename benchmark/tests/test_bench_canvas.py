"""The readers of the R-CNN predictor's canvas, ``canvas_ms.stream`` and
``upload_mb.stream``: nothing read from a program without the span
``predictor.canvas`` or the counter ``predictor.upload_bytes`` (an older
tree), the request's span and the counters read from a profiled run, and
both in the line of ViTDet's stream cell traced on the CPU at a small
size."""
from __future__ import annotations

import math
import time

import torch

from benchmark.common import harness, trace
from benchmark.tests.test_bench_vitdet import run, small  # noqa: F401
from tpuseg_torch.utils import timer

NAMES = ("canvas_ms.stream", "upload_mb.stream")


def profiled(canvas: bool):
    """Three requests, each with its canvas span (or none), and the
    counters of two images a request (the bytes only with the span)."""
    timer.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timer.span("predictor.request"):
                if canvas:
                    with timer.span("predictor.canvas"):
                        time.sleep(0.002)
                    timer.count("predictor.upload_bytes", 2_000_000)
                time.sleep(0.001)
            timer.count("predictor.images", 2)
    return {"prof": prof, "events": trace.events_of(prof)}


def test_a_program_without_the_canvas_span_or_bytes_reads_as_nothing():
    timer.reset()
    ctx = {"prof": None, "events": [trace.Event("k", 0, 10, True, False)]}
    for name in NAMES:
        assert harness.metric_reader(name)(dict(ctx)) is None, name
    ctx = profiled(canvas=False)
    for name in NAMES:
        assert harness.metric_reader(name)(dict(ctx)) is None, name


def test_readers_take_the_request_span_and_the_counters():
    ctx = profiled(canvas=True)
    assert 2.0 <= harness.metric_reader("canvas_ms.stream")(dict(ctx)) < 50.0
    assert harness.metric_reader("upload_mb.stream")(dict(ctx)) == 1.0


def test_traced_small_vitdet_run_reports_the_canvas_metrics(small):  # noqa: F811
    """On the CPU the predictor builds its canvases on the host: the
    bytes sent are the f32 canvases, 3 x 128 x 128 x 4 an image."""
    timer.reset()
    res, _, _ = run(small, 2**31 + 34, traced=True)
    got = res["metrics"]
    assert res["correct"]
    assert got["canvas_ms.stream"]["value"] > 0
    assert math.isclose(got["upload_mb.stream"]["value"], 3 * 128 * 128 * 4e-6)
    assert "predictor.canvases_on_device" not in timer.counters()
