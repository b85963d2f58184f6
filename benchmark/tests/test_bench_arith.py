"""Percentiles, spreads and the trace arithmetic on synthetic traces."""
from __future__ import annotations

import statistics

import numpy as np
import pytest

from benchmark.common import stats, trace


def test_percentile_is_numpys_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 301):
        x = rng.exponential(size=n).tolist()
        for q in (0, 5, 50, 95, 99, 100):
            assert stats.percentile(x, q) == pytest.approx(np.percentile(x, q))


def test_quartile_spread_is_statistics_quantiles():
    x = [10.0, 10.2, 9.9, 10.4, 10.1, 9.8]
    q1, q2, q3 = statistics.quantiles(x, n=4)
    assert stats.quartile_spread(x) == (q3 - q1) / q2


def ev(name, s, e, dev=True, span=False):
    return trace.Event(name, s, e, dev, span)


def test_busy_is_the_union_of_overlapping_intervals():
    events = [ev("a", 0, 10), ev("b", 5, 15), ev("c", 20, 30),
              ev("host", 0, 100, dev=False)]
    assert trace.busy_ns(events, 0, 40) == 25  # a sum would say 30
    assert trace.busy_ns(events, 8, 25) == 12
    assert trace.merge([(5, 15), (0, 10), (20, 30), (30, 31)]) == [
        (0, 15), (20, 31)]


def test_idle_gaps_and_their_labels():
    events = [ev("k1", 10, 20), ev("k2", 50, 60),
              ev("bench/batch_build", 20, 50, dev=False, span=True),
              ev("aten::copy_", 30, 40, dev=False),
              ev("bench/step", 0, 100, dev=False, span=True)]
    assert trace.idle_gaps(events, 0, 100) == [(0, 10), (20, 50), (60, 100)]
    gaps = trace.longest_gaps(events, 0, 100, top=2)
    assert gaps == [["bench/step", 40e-9], ["bench/batch_build", 30e-9]]
    assert trace.host_label(events, 35) == "bench/batch_build"
    assert trace.host_label([ev("aten::mm", 0, 9, dev=False)], 5) == "aten::mm"
    assert trace.host_label([], 5) == "none"


def test_device_time_by_name_and_kernels():
    events = [ev("roi_align_kernel<float>", 0, 10),
              ev("roi_align_bwd_kernel<float>", 10, 30),
              ev("roi_align_kernel<float>", 40, 45), ev("gemm", 0, 100)]
    assert trace.top_ops(events, 2) == [["gemm", 100e-9],
                                        ["roi_align_bwd_kernel<float>", 20e-9]]
    assert trace.kernel_seconds(events, ("roi_align_kernel",)) == 15e-9
    assert trace.kernel_seconds(events, ("roi_align_kernel",
                                         "roi_align_bwd_kernel")) == 35e-9
