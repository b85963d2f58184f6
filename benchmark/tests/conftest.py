"""The benchmark's own tests (``python3 -m pytest benchmark/tests``): on
the CPU, at sizes a test run holds. The configurations are cut by
monkeypatching, never in the files the benchmark runs."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.common import dataset, harness  # noqa: E402

SMALL_DATASET = {"images": 12, "sizes": [[96, 64], [64, 96], [80, 60]]}


@pytest.fixture
def small_cells(monkeypatch, tmp_path):
    """Mask R-CNN on a 64/96 canvas over 12 small images, YOLACT++ at
    96 px over 6 frames: the harness's whole run on the CPU."""
    torch.set_num_threads(2)
    from benchmark.configs import yolactpp_r50 as YC
    from benchmark.reference import yolactpp_r50 as YR

    monkeypatch.setattr(dataset, "CACHE", tmp_path / "data")
    sizes, traffic = harness.config_sizes, harness.traffic

    def small_sizes(name):
        s = sizes(name)
        s.update(min_size_train=64, max_size_train=96)
        return s

    def small_traffic(name):
        m = traffic(name)
        if m["window"] == "train":
            m["dataset"].update(SMALL_DATASET)
        else:
            m.update(frames=6, sample=3)
        return m

    monkeypatch.setattr(harness, "config_sizes", small_sizes)
    monkeypatch.setattr(harness, "traffic", small_traffic)
    ref_cfg, port_cfg = YR.model_config, YC.yolact_model_config
    monkeypatch.setattr(YR, "model_config", lambda s: dataclasses.replace(
        ref_cfg(s), img_size=96))
    monkeypatch.setattr(YC, "yolact_model_config", lambda p: dataclasses.replace(
        port_cfg(p), img_size=96))
    monkeypatch.setattr(harness.entry_module("yolactpp_r50",
                                             {"window": "stream"}),
                        "CALIBRATION_FRAMES", 2)
    return harness.load_spec()


def run_small(spec, cell: str, seed: int, control=None, seconds=None):
    """One run on the CPU; a stream's window long enough to serve each of
    its frames."""
    import time

    if seconds is None:
        seconds = 4.0 if harness.traffic(
            harness.cell_of(spec, cell)["traffic"])["window"] == "stream" else 1.0
    res, checks, _ = harness.run_cell(spec, harness.cell_of(spec, cell), seed,
                                      seconds, False, time.perf_counter(),
                                      dev=torch.device("cpu"), control=control)
    return res, checks
