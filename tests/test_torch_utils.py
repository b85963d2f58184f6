"""``tpuseg_torch/utils``: the port's counterparts of
``tests/test_parallel.py::test_measure_throughput`` and
``tests/test_train_loop.py::test_timer_and_logging``; ``MovingAverage``,
``ProgressBar`` and ``Log`` against tpuseg's on the same inputs; a
``torch.profiler`` trace on the CPU."""
import json

import numpy as np
import torch

from tpuseg.utils import logging as jlog
from tpuseg_torch.utils import logging as tlog
from tpuseg_torch.utils import profiler, timer


def test_measure_throughput():
    x = torch.ones((8, 8))
    ips, ms = profiler.measure_throughput(lambda t: {"y": t * 2}, x, iters=5,
                                          warmup=1, items_per_call=8)
    assert ips > 0 and ms > 0
    assert profiler.block_until_ready((x, [x])) == (x, [x])


def test_timer_env_stats_and_disable(capsys):
    timer.reset()
    with timer.env("stage_a"):
        sum(range(1000))
    with timer.env("stage_a"):
        pass
    timer.disable("stage_b")
    with timer.env("stage_b"):
        pass
    timer.enable("stage_b")
    out = timer.print_stats()
    assert "stage_a" in out and "stage_b" not in out
    assert out.splitlines()[2].split("|")[1].strip() == "2"
    assert timer.total_time() > 0
    assert "stage_a" in capsys.readouterr().out


def test_logging_matches_tpuseg(tmp_path):
    rng = np.random.default_rng(0)
    values = list(rng.standard_normal(40)) + [float("nan"), float("inf")]
    for size in (1, 3, 1000):
        got, want = tlog.MovingAverage(size), jlog.MovingAverage(size)
        for v in values:
            got.add(v)
            want.add(v)
            assert got.get_avg() == want.get_avg() and len(got) == len(want)
    for n, m in ((10, 100), (7, 3), (10, 0)):
        for v in (0, 1, m // 2, m, m + 5):
            a, b = tlog.ProgressBar(n, m), jlog.ProgressBar(n, m)
            a.set_val(v)
            b.set_val(v)
            assert repr(a) == repr(b)
    log = tlog.Log("test", log_dir=str(tmp_path))
    log.log("train", {"loss": 1.5}, iter=10)
    log.log("val", box=0.25)
    lines = [json.loads(s) for s in open(log.path)]
    assert [e["type"] for e in lines] == ["train", "val"]
    assert lines[0]["data"] == {"loss": 1.5, "iter": 10}
    assert lines[1]["data"] == {"box": 0.25}
    assert tlog.Log("test", str(tmp_path), overwrite=True).path == log.path
    assert not (tmp_path / "test.log").exists()


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    with profiler.trace(str(tmp_path / "t")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert events["traceEvents"]
    assert "trace written to" in capsys.readouterr().out
