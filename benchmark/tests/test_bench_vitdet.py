"""ViTDet-B's stream cell, ``maskrcnn_vitdet_b.stream_b1``: its entry
point and references load, the references import nothing of the port and
no JAX, the attention bound counts what it says on a shape worked by hand,
and ``correct`` comes out true for the program and false with a zeroed
relative-position table or inverted mask logits planted, on the CPU at
small sizes (monkeypatched, as ``conftest.py`` does) and at the cell's own
size on the card (``-m cuda``, each seed's numbers printed with ``-s``: the
readings the limits are set from, the bf16 control's among them)."""
from __future__ import annotations

import json
import math
import time

import pytest
import torch

from benchmark.common import check, harness, program, vit_attention as A
from benchmark.tests.test_bench_harness import imports_of
from tpuseg_torch.utils import timer

VIT = "maskrcnn_vitdet_b.stream_b1"
STREAM = {"window": "stream"}
SECONDS = 8.0  # the card: a first result of each of the 12 sampled frames
PROGRAM_SEEDS = tuple(3601000001 + i for i in range(12))
SEEDS = (3602000001, 3602000002, 3602000003)

# ViTDet at a CPU test's size: 6 blocks (global at 2, 5), a window of 3
# over the 8 x 8 grid of a 128 canvas, 4 classes
SMALL_VIT = dict(img_size=128, embed_dim=96, depth=6, num_heads=2,
                 window_size=3, window_block_indexes=[0, 1, 3, 4],
                 pretrain_img_size=96, out_channels=32, num_classes=4,
                 box_head_fc_dims=[64], min_size_test=128, max_size_test=128)


def entry():
    return harness.entry_module("maskrcnn_vitdet_b", STREAM)


def planted(mp, fault) -> None:
    """``fault(model)`` applied to the program's predictor's model."""
    mod = entry()
    make = mod.make_predictor

    def faulty(*args, **kwargs):
        pred = make(*args, **kwargs)
        with torch.no_grad():
            fault(pred.model)
        return pred

    mp.setattr(mod, "make_predictor", faulty)


def zeroed_relative_table(model) -> None:
    """The first block's width table of the backbone set to zero."""
    model.backbone.net.blocks[0].attn.rel_pos_w.zero_()


def inverted_mask_logits(model) -> None:
    """The mask head's class logits negated: every mask inverted, the
    boxes and scores untouched."""
    logits = model.roi_heads.mask.predictor.mask_fcn_logits
    logits.weight.neg_()
    logits.bias.neg_()


def test_entry_points_and_references_load():
    mod = entry()
    for name in ("serve_state", "make_predictor", "request",
                 "flops_per_request"):
        assert callable(getattr(mod, name)), name
    assert mod.STREAM_SPANS == {"forward": ("forward", True)}
    ref = harness.reference_module("maskrcnn_vitdet_b", STREAM)
    assert callable(ref.requests)
    assert harness.config_module("maskrcnn_vitdet_b").model_config(
        harness.config_sizes("maskrcnn_vitdet_b")).num_classes == 81


def test_references_import_nothing_of_the_port_nor_jax():
    ref = harness.BENCH / "reference"
    files = [ref / "frozen" / "vitdet.py",
             ref / "frozen" / "maskrcnn_infer.py",
             ref / "maskrcnn_vitdet_b.py", ref / "maskrcnn_vitdet_b.stream.py"]
    for p in files:
        names = imports_of(p)
        assert not names & {"tpuseg_torch", "tpuseg", "jax", "jaxlib",
                            "flax"}, (p, names)


def test_attention_bound_counts_the_scores_terms_softmax_and_pv():
    """n = 2 grids of 2 x 3 tokens of 4 channels: t = 6 tokens a grid."""
    t, c, kh, kw = 6, 4, 2, 3
    per_grid = (2 * t * t * c  # q k^T: 288
                + 2 * t * (kh + kw) * c  # the relative products: 240
                + 2 * t * t  # their adds into the scores: 72
                + 5 * t * t  # softmax: 180
                + 2 * t * t * c)  # P v: 288
    assert per_grid == 1068
    assert A.attention_ops(2, kh, kw, c) == 2 * 1068
    # q, k, v and the output (4 x 2 x 6 x 4 values), the tables (3 + 5 rows
    # of 4), float32
    assert A.attention_bytes(2, kh, kw, c, 4) == 4 * (192 + 32)
    # ViTDet-B's global block: the f32 operations dominate
    ops = A.attention_ops(12, 64, 64, 64)
    assert math.isclose(A.attention_bound(12, 64, 64, 64, 4), ops / 67e12)
    assert 5.3e10 < ops < 5.4e10


def test_block_shapes_from_the_weights():
    sizes = harness.config_sizes("maskrcnn_vitdet_b")
    cfg = harness.config_module("maskrcnn_vitdet_b").model_config(sizes)
    from tpuseg_torch.models import vitdet as VD

    with torch.device("meta"):
        sd = VD.ViTDetMaskRCNN(cfg).state_dict()
    shapes = A.block_shapes(sd)
    assert sorted(set(shapes)) == [(14, 14, 64, 12), (64, 64, 64, 12)]
    assert shapes.count((64, 64, 64, 12)) == 4


@pytest.fixture
def small(small_cells, monkeypatch):
    """The cell at a CPU size: ViTDet as SMALL_VIT, 6 frames and 3
    checked."""
    sizes = harness.config_sizes

    def small_sizes(name):
        s = sizes(name)
        if name == "maskrcnn_vitdet_b":
            s.update(SMALL_VIT)
        return s

    monkeypatch.setattr(harness, "config_sizes", small_sizes)
    return small_cells


def run(spec, seed, traced=False, seconds=6.0, dev=None, control=None):
    cell = next(w for w in spec["workloads"] if w["name"] == VIT)
    return harness.run_cell(spec, cell, seed, seconds, traced,
                            time.perf_counter(),
                            dev=dev or torch.device("cpu"), control=control)


def check_numbers(log: list) -> dict:
    line = next(line for line in log if line.startswith("check: "))
    return json.loads(line[len("check: "):].rsplit(" (", 1)[0])


def test_sound_small_run_is_correct(small):
    res, checks, log = run(small, 2**31 + 31)
    assert res["correct"], (checks, log)
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault, over, within", [
    (zeroed_relative_table, ("det_miss", "score_err"), ()),
    (inverted_mask_logits, ("mask_in_err",), ("det_miss", "score_err"))])
def test_planted_fault_is_not_correct(small, monkeypatch, fault, over,
                                      within):
    """A zeroed table moves the detections past their limits; inverted
    mask logits leave them within theirs, and only ``mask_in_err`` sees
    them."""
    planted(monkeypatch, fault)
    res, _, log = run(small, 2**31 + 32)
    assert not res["correct"], log
    got, limits = check_numbers(log), check.limits_of(VIT)
    assert all(got[k] > limits[k] for k in over), got
    assert all(got[k] <= limits[k] for k in within), got


def test_traced_small_run_reports_the_vit_metrics(small):
    timer.reset()
    res, _, _ = run(small, 2**31 + 33, traced=True)
    got = res["metrics"]
    assert res["correct"]
    # a 9 x 9 padded grid over 8 x 8 tokens
    assert math.isclose(got["window_pad_pct.stream"]["value"], 1700 / 81)
    for name in ("issue_ms.stream", "paste_ms.stream", "download_ms.stream",
                 "masks_per_request.stream", "download_mb.stream",
                 "forward_ms.stream", "predictor_host_ms.stream"):
        assert name in got and got[name]["value"] >= 0, name
    # no device copies of the ranges on the CPU: nothing to read
    for name in ("global_attn_ms.stream", "window_attn_ms.stream",
                 "vit_attn_roofline.stream"):
        assert name not in got, name


def test_device_copies_are_read_and_hosts_left_aside():
    from benchmark.common import trace

    ev = [trace.Event("k1", 10, 20, True, False),
          trace.Event("k2", 25, 40, True, False),
          trace.Event("k3", 45, 60, True, False)]
    ctx = {"prof": None, "events": ev, "items": 2,
           "program_device_ranges": {"vit.global_attn": [(5, 41)]}}
    assert A.device_ns_inside(ev, [(5, 41)]) == 25
    assert A.device_ms_per_request(ctx, "vit.global_attn") == 25 / 1e6 / 2
    assert A.device_ms_per_request(ctx, "vit.window_attn") is None
    bare = {"prof": None, "events": ev, "items": 2}
    assert A.device_ms_per_request(bare, "vit.global_attn") is None
    assert program.stage_ms(bare, "predictor.request",
                            "vit.global_attn") is None


# ---------------------------------------------------------------------------
# at the cells' own sizes, on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check runs at the cell's size")
    return torch.device("cuda", 0)


def card_runs(dev, seeds, control=None) -> list:
    """-> [correct] of one run a seed, each seed's numbers printed."""
    spec = harness.load_spec()
    out = []
    for seed in seeds:
        res, _, log = run(spec, seed, seconds=SECONDS, dev=dev,
                          control=control)
        numbers = next(line for line in log if line.startswith("check: "))
        print(f"\n{VIT} seed {seed} control {control} correct "
              f"{res['correct']} {numbers}", flush=True)
        out.append(res["correct"])
    return out


@pytest.mark.cuda
def test_program_is_correct_on_a_dozen_seeds(card):
    assert all(card_runs(card, PROGRAM_SEEDS))


@pytest.mark.cuda
def test_control_is_not_correct_at_the_cells_size(card):
    assert not any(card_runs(card, SEEDS, control="bf16"))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [zeroed_relative_table,
                                   inverted_mask_logits])
def test_planted_fault_is_not_correct_at_the_cells_size(card, monkeypatch,
                                                         fault):
    planted(monkeypatch, fault)
    assert not any(card_runs(card, SEEDS))
