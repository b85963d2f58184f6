"""``correct`` at each cell's own size, on the card (``-m cuda``; each
skips without one): true for the program on a dozen seeds, false for the
control (the configuration's bf16 path in the program's place) and for
each fault planted under the timed path (``faults.py``) on three seeds.
Every seed's numbers are printed (``-s``): the readings the limits are set
from. On the CPU, ``test_bench_correct.py`` runs the same at small sizes."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark.common import harness
from benchmark.tests import faults

TRAIN = "maskrcnn_r50fpn.train_b2"
STREAM = "yolactpp_r50.stream_b1"
CELLS = (TRAIN, STREAM)
# long enough for the window's first training step and, in the stream, a
# first result of every sampled frame
SECONDS = {TRAIN: 3.0, STREAM: 8.0}
SEEDS = (3301000001, 3301000002, 3301000003)
PROGRAM_SEEDS = tuple(3501000001 + i for i in range(12))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check runs at the cell's size")
    return torch.device("cuda", 0)


def runs(dev, cell: str, seeds, control=None) -> list:
    """-> [correct] of one run a seed, each seed's numbers printed."""
    spec = harness.load_spec()
    out = []
    for seed in seeds:
        res, _, log = harness.run_cell(
            spec, harness.cell_of(spec, cell), seed, SECONDS[cell], False,
            time.perf_counter(), dev=dev, control=control)
        numbers = next(line for line in log if line.startswith("check: "))
        print(f"\n{cell} seed {seed} control {control} correct "
              f"{res['correct']} {numbers}", flush=True)
        out.append(res["correct"])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct_on_a_dozen_seeds(card, cell):
    assert all(runs(card, cell, PROGRAM_SEEDS))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(card, cell):
    assert not any(runs(card, cell, SEEDS, control="bf16"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell,plant", [
    (TRAIN, faults.roi_level_below),
    (TRAIN, faults.roi_grad_second_image_left_out),
    (STREAM, faults.masks_nearest),
], ids=["k2_level_below", "k3_second_image_left_out", "masks_nearest"])
def test_fault_is_not_correct_at_the_cells_size(card, monkeypatch, cell, plant):
    plant(monkeypatch)
    assert not any(runs(card, cell, SEEDS))
