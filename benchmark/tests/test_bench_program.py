"""The readers of the program's own spans and counters
(``common/program.py``): grouping by parent, the device's copy of a range
left out, idle time under a span, on synthetic events; nothing read from a
program without them; and each cell traced on the CPU with every reader
of the program's spans and counters in its line."""
from __future__ import annotations

import math
import time

import pytest
import torch

from benchmark.common import harness, program, trace
from tpuseg_torch.utils import timer

NEW = {
    "maskrcnn_r50fpn.train_b2": (
        "decode_ms.train", "gt_masks_ms.train", "resize_ms.train",
        "mask_crops_ms.train", "upload_ms.train", "issue_ms.train",
        "readback_ms.train", "idle_in_batch_pct.train", "gt_per_image.train",
        "upload_mb.train"),
    "yolactpp_r50.stream_b1": (
        "issue_ms.stream", "download_ms.stream", "paste_ms.stream",
        "idle_in_paste_pct.stream", "masks_per_request.stream",
        "download_mb.stream"),
}


def rng(name, s, e, on_host=True):
    return program.Range(name, s, e, on_host)


def test_stages_are_summed_per_parent_inside_the_trace():
    spans = program.host_ranges([
        rng("iter", 0, 100), rng("iter", 100, 200), rng("iter", 190, 320),
        rng("decode", 10, 20), rng("decode", 30, 45), rng("decode", 120, 130),
        rng("decode", 195, 205),
        # the device's copy of a range over its kernels: never read
        rng("decode", 12, 90, on_host=False),
        rng("step", 60, 90)])
    assert spans["decode"] == [(10, 20), (30, 45), (120, 130), (195, 205)]
    # the third iteration ends past the trace: left out
    assert program.per_parent(spans, "iter", "decode", 0, 300) == [
        25e-9, 10e-9]
    assert program.per_parent(spans, "iter", "step", 0, 400) == [
        30e-9, 0.0, 0.0]
    assert program.per_parent(spans, "iter", "upload", 0, 400) == [0.0] * 3
    assert program.per_parent(spans, "request", "decode", 0, 400) == []


def test_idle_time_under_a_span():
    ev = [trace.Event("k1", 0, 10, True, False),
          trace.Event("k2", 40, 60, True, False),
          trace.Event("k3", 90, 100, True, False),
          trace.Event("tpuseg_torch/paste", 5, 50, False, False)]
    spans = {"paste": [(5, 30), (20, 50)], "run": [(60, 90)]}
    # idle: [10, 40) and [60, 90), 60 ns; under paste [10, 40): 30 ns
    assert program.idle_share_under(ev, spans, "paste") == 0.5
    assert program.idle_share_under(ev, spans, "run") == 0.5
    assert program.idle_share_under(ev, spans, "upload") is None
    assert program.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10


def test_a_program_without_spans_or_counters_reads_as_nothing(monkeypatch):
    ctx = {"prof": None, "events": [trace.Event("k", 0, 10, True, False)]}
    assert program.stage_ms(ctx, "loop.iter", "loop.decode") is None
    assert program.idle_pct_under(ctx, "loop.batch") is None
    monkeypatch.delattr(timer, "counters")
    assert program.counters() == {}
    assert program.counter_ratio("loop.gt_objects", "loop.images") is None
    for cell, names in NEW.items():
        for name in names:
            assert harness.metric_reader(name)(dict(ctx)) is None, name


def test_readers_take_the_ranges_of_a_profiled_run():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timer.span("bench_test.parent"):
                with timer.span("bench_test.stage"):
                    time.sleep(0.002)
    rows = program.ranges_of(prof)
    assert len(rows) == 6 and all(r.on_host for r in rows)
    ctx = {"prof": prof, "events": trace.events_of(prof)}
    ms = program.stage_ms(ctx, "bench_test.parent", "bench_test.stage")
    assert 2.0 <= ms < 50.0


@pytest.mark.parametrize("cell", sorted(NEW))
def test_each_cell_traced_on_the_cpu_reports_the_programs_metrics(
        small_cells, cell):
    timer.reset()
    seconds = 4.0 if cell.startswith("yolact") else 1.0
    res, _, _ = harness.run_cell(small_cells, harness.cell_of(small_cells, cell),
                                 2**31 + 21, seconds, True, time.perf_counter(),
                                 dev=torch.device("cpu"))
    assert res["correct"]
    got = res["metrics"]
    for name in NEW[cell]:
        assert name in got and math.isfinite(got[name]["value"]), name
        assert got[name]["value"] >= 0, name
    if cell.startswith("maskrcnn"):
        assert got["upload_ms.train"]["value"] > 0
        assert 0 < got["idle_in_batch_pct.train"]["value"] <= 100
        c = timer.counters()
        assert c["loop.images"] == 2 * c["loop.batches"]
    else:
        assert got["download_mb.stream"]["value"] > 0
        assert 0 < got["idle_in_paste_pct.stream"]["value"] <= 100
