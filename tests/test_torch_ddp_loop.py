"""``yolact_train_loop.train`` under a process group: 2 gloo ranks of the
CPU against one process, 2 steps at a global batch of 12 on a 12-image
dataset (each rank builds the global batch and keeps its 6; train-mode
BatchNorm synchronised), and the ``freeze_bn`` rule by the batch a rank
sees (a global 8 on 2 ranks is 4 a rank: frozen, not synchronised; one
process at 8 trains it).

The loop runs in f64 here (the model, and the batches cast at upload by
the rank job): in f32 the two runs' ~1e-7 differences (the ranks' BN
statistics combine per-rank means) grow through train-mode BatchNorm's
backward, and after one SGD step the second step's losses differed by
1e-4-2e-3 relative and BatchNorm biases by up to 0.4 of their max,
against 5e-13 in f64 (measured here). The gate: losses and every
parameter and running statistic within 1e-9 (of each tensor's max)."""
import pytest
import torch

from tests import torch_ranks
from tpuseg_torch.models import yolact as Y

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

CFG = Y.YolactConfig(img_size=64, num_classes=4, nms_top_k=8,
                     max_num_detections=5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    state = Y.build_model(CFG, torch.Generator().manual_seed(0)).state_dict()
    inp = {"cfg": CFG, "state": state, "runs": [(12, 2), (8, 1)]}
    ranks = torch_ranks.start("train_loop", 2,
                              tmp_path_factory.mktemp("loop"), inp)
    one = torch_ranks.train_loop_job(inp)
    return {"ranks": ranks.wait(timeout=240), "one": one, "state": state}


def test_two_ranks_train_as_one_process(runs):
    one = runs["one"][0]
    assert one["it"] == 2 and not one["freeze_bn"] and not one["synced"]
    for r in runs["ranks"]:
        got = r[0]
        assert got["it"] == 2 and not got["freeze_bn"] and got["synced"]
        assert len(got["history"]) == 2
        for h_got, h_one in zip(got["history"], one["history"]):
            assert h_got.keys() == h_one.keys()
            for k, v in h_one.items():
                assert abs(h_got[k] - v) <= 1e-9 * abs(v), (k, h_got[k], v)
        for k, want in one["state"].items():
            if not want.is_floating_point():
                assert torch.equal(got["state"][k], want), k
                continue
            scale = float(want.abs().max())
            err = float((got["state"][k] - want).abs().max())
            assert err <= 1e-9 * max(scale, 1e-12), (k, err, scale)
    moved = [k for k, v in one["state"].items()
             if v.is_floating_point() and not torch.equal(v, runs["state"][k])]
    assert any(k.endswith("running_var") for k in moved)


def test_freeze_bn_follows_the_batch_a_rank_sees(runs):
    assert not runs["one"][1]["freeze_bn"]  # 8 on one process
    for r in runs["ranks"]:
        assert r[1]["freeze_bn"] and not r[1]["synced"]  # 4 a rank
