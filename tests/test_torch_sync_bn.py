"""``tpuseg_torch/parallel/sync_bn.py``: ``SyncBatchNorm2d`` on 2 gloo
ranks in f64 against ``BatchNorm2d`` on the concatenated batch (output,
d input, the ranks' d weight and d bias summed, the running statistics:
1e-12), with one rank exactly ``F.batch_norm``; ``convert_sync_bn`` keeps
the modules, their state_dict keys, ``isinstance`` and DarkNet's folded
eval mode."""
import copy

import pytest
import torch
import torch.nn.functional as F

from tests import torch_ranks
from tpuseg_torch.nn.darknet import BatchNorm2d as DarkNetBatchNorm2d
from tpuseg_torch.parallel.ddp import all_reduce
from tpuseg_torch.parallel.mesh import ThreadGroup
from tpuseg_torch.parallel.sync_bn import SyncBatchNorm2d, convert_sync_bn

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

TOL = 1e-12


def _bn_inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 6, 5, 7), generator=g, dtype=torch.float64) * 3 + 2
    bn = torch.nn.BatchNorm2d(6).double()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-1, 1, generator=g)
        bn.running_mean.uniform_(-1, 1, generator=g)
        bn.running_var.uniform_(0.5, 2, generator=g)
    return x, torch.randn(x.shape, generator=g, dtype=torch.float64), bn


def _reference(x, g, bn):
    ref = copy.deepcopy(bn).train()
    xr = x.clone().requires_grad_()
    y = ref(xr)
    (y * g).sum().backward()
    return {"y": y.detach(), "dx": xr.grad, "dw": ref.weight.grad,
            "db": ref.bias.grad, "running_mean": ref.running_mean,
            "running_var": ref.running_var}


def _close(got, want, what):
    assert torch.allclose(got, want, rtol=TOL, atol=TOL), (
        what, float((got - want).abs().max()))


def test_two_gloo_ranks_match_batchnorm_on_the_whole_batch(tmp_path):
    x, g, bn = _bn_inputs()
    want = _reference(x, g, bn)
    outs = torch_ranks.spawn("sync_bn", 2, tmp_path,
                             {"x": x, "g": g, "state": bn.state_dict()},
                             timeout=60)
    _close(torch.cat([o["y"] for o in outs]), want["y"], "y")
    _close(torch.cat([o["dx"] for o in outs]), want["dx"], "d x")
    # each rank holds its own part of d weight and d bias; DDP sums them
    _close(outs[0]["dw"] + outs[1]["dw"], want["dw"], "d weight")
    _close(outs[0]["db"] + outs[1]["db"], want["db"], "d bias")
    for o in outs:
        _close(o["running_mean"], want["running_mean"], "running mean")
        _close(o["running_var"], want["running_var"], "running var")
        assert int(o["num_batches_tracked"]) == 1


def test_thread_group_matches_the_gloo_ranks():
    """The one-process reference of the card's two-rank phase: the same
    statistics from two threads."""
    x, g, bn = _bn_inputs()
    want = _reference(x, g, bn)
    mods = [convert_sync_bn(copy.deepcopy(bn).train()) for _ in range(2)]

    def rank(r):
        xs = x[4 * r:4 * r + 4].clone().requires_grad_()
        y = mods[r](xs)
        (y * g[4 * r:4 * r + 4]).sum().backward()
        return y.detach(), xs.grad

    outs = ThreadGroup(2).run(rank)
    _close(torch.cat([o[0] for o in outs]), want["y"], "y")
    _close(torch.cat([o[1] for o in outs]), want["dx"], "d x")
    _close(mods[0].weight.grad + mods[1].weight.grad, want["dw"], "d weight")
    for m in mods:
        _close(m.running_var, want["running_var"], "running var")


def test_one_rank_is_exactly_batch_norm():
    x, _, bn = _bn_inputs()
    sync = convert_sync_bn(copy.deepcopy(bn))
    assert torch.equal(sync.eval()(x), bn.eval()(x))
    want = F.batch_norm(x, bn.running_mean.clone(), bn.running_var.clone(),
                        bn.weight, bn.bias, True, 0.1, bn.eps)
    assert torch.equal(sync.train()(x), want)


def test_convert_keeps_modules_keys_and_darknet_eval():
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1),
                              torch.nn.BatchNorm2d(4), DarkNetBatchNorm2d(4))
    keys = list(net.state_dict())
    bn_objects = [net[1], net[2]]
    x = torch.randn(2, 4, 3, 3)
    dark_eval = net[2].eval()(x)
    convert_sync_bn(net)
    assert list(net.state_dict()) == keys
    assert [net[1], net[2]] == bn_objects
    assert type(net[1]) is SyncBatchNorm2d
    assert isinstance(net[2], (SyncBatchNorm2d, DarkNetBatchNorm2d))
    assert isinstance(net[2], torch.nn.BatchNorm2d)
    assert torch.equal(net[2].eval()(x), dark_eval)


def test_errors_of_a_rank_reach_the_caller():
    """A rank that raises breaks the others' wait; the error reaches the
    caller."""
    def rank(r):
        if r == 1:
            raise ValueError("rank 1 failed")
        return all_reduce(torch.ones(1))

    with pytest.raises(ValueError, match="rank 1 failed"):
        ThreadGroup(2).run(rank)
