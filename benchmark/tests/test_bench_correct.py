"""``correct`` comes out true for the program and false for the control
(the configuration's bf16 path in the program's place) and for each fault
a cell can have, planted under the timed path (``faults.py``): the whole
run but the look for a card, on the CPU at small sizes (``conftest.py``).
``test_bench_control_cuda.py`` holds the same at each cell's own size on
the card."""
from __future__ import annotations

import pytest
import torch

from benchmark.common import dataset, harness
from benchmark.tests import faults
from benchmark.tests.conftest import run_small

TRAIN = "maskrcnn_r50fpn.train_b2"
STREAM = "yolactpp_r50.stream_b1"
CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", [TRAIN, STREAM])
def test_sound_run_is_correct(small_cells, cell):
    res, checks = run_small(small_cells, cell, 2**31 + 7)
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", [STREAM])
def test_control_is_not_correct(small_cells, cell):
    """Mask R-CNN's control is held at its own size on the card
    (``test_bench_control_cuda.py``): on a small canvas its bf16 first
    step stays within the limits."""
    res, checks = run_small(small_cells, cell, 2**31 + 8, control="bf16")
    assert not res["correct"], checks


@pytest.mark.parametrize("plant,seed", [
    (faults.state_unchanged, 2**31 + 9),
    (faults.half_batch, 2**31 + 10),
])
def test_training_fault_is_not_correct(small_cells, monkeypatch, plant, seed):
    plant(monkeypatch)
    res, checks = run_small(small_cells, TRAIN, seed)
    assert not res["correct"], checks


def test_fault_in_the_window_alone_is_not_correct(small_cells, monkeypatch):
    """Half the batch left out from the window's first step on, the set-up
    steps sound: the window's step is checked too."""
    seed = 2**31 + 12
    mix = harness.traffic("train_b2")
    entry = harness.entry_module("maskrcnn_r50fpn", mix)
    warm = max(entry.warm_steps(dataset.ensure(mix["dataset"]), mix, seed), 4)
    faults.half_batch(monkeypatch, from_call=warm + 1)
    res, checks = run_small(small_cells, TRAIN, seed)
    assert not res["correct"], checks


@pytest.mark.parametrize("plant", [faults.classes_moved, faults.masks_nearest])
def test_stream_fault_is_not_correct(small_cells, monkeypatch, plant):
    plant(monkeypatch)
    res, checks = run_small(small_cells, STREAM, 2**31 + 11)
    assert not res["correct"], checks
