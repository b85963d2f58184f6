"""The YOLACT++ training step in bf16 mixed precision
(``yolact_train_loop.train_step(compute_dtype=bfloat16)``) against
tpuseg's ``YolactTrainer(compute_dtype=bfloat16)``, with frozen BatchNorm
as ``tests/test_train_loop.py::test_mixed_precision_train_step_matches_f32``
isolates the cast: yolact_plus_resnet50 at full width on a 64x64 canvas, 4
classes, B = 2 (``tests/test_torch_yolact_train.py``'s model, weights,
inputs and the JAX package's mask-subset draws).

Held: the losses term by term against tpuseg's (measured on the CPU:
within 3.1e-3 relative but FastMaskIoUNet's I, 2.0e-2, where the port's
own f32 step lies 2.7e-2 from tpuseg's bf16 one; held at 1e-2 and 5e-2);
the master parameters and the SGD update stay f32; each parameter's
update against the port's own f32 update on the same batch by relative
L2 (measured: median 5.0e-2, largest 0.146, the DCN offset convs; held at
0.1 and 0.3). And on a small module, the running-statistics rule of
train-mode BatchNorm under the cast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_yolact_loss import jax_draws
from tests.test_torch_yolact_train import (B, CFG, JCFG, KEY, LOSS, _inputs,
                                           _jax_params, _port_targets,
                                           _state_dict)
from tpuseg.engine import trainer as JT
from tpuseg.models import yolact_loss as JL
from tpuseg_torch.engine import trainer as TT
from tpuseg_torch.engine import yolact_train_loop as TL
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.models import yolact_loss as YL
from tpuseg_torch.weights.from_jax import yolact_state_dict_from_jax

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

LR = 1e-4  # yolact's warm-up lr at iteration 0
LOSS_RTOL = {"I": 5e-2}  # the rest 1e-2
UPDATE_L2 = 0.3
UPDATE_L2_MEDIAN = 0.1


def _model(sd: dict, freeze_bn: bool) -> Y.Yolact:
    model = Y.build_model(CFG)
    model.load_state_dict(yolact_state_dict_from_jax(
        jax.tree.map(lambda a: None if a is None else np.asarray(a),
                     _jax_params(sd, jnp.float32),
                     is_leaf=lambda a: a is None), CFG), strict=True)
    model.freeze_bn = freeze_bn
    return model.train()


def _port_step(model, images, targets, draws, dtype) -> dict:
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = TT.make_yolact_optimizer(model)
    losses = TL.train_step(
        model, opt, LR, torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
        _port_targets(targets, torch.float32),
        torch.from_numpy(Y.make_priors_np(CFG)), draws,
        YL.YolactLossConfig(**LOSS), compute_dtype=dtype)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "delta": {n: p.detach() - before[n]
                      for n, p in model.named_parameters()},
            "model": model}


@pytest.fixture(scope="module")
def steps():
    rng = np.random.default_rng(11)
    sd = _state_dict()
    images, targets = _inputs(rng)
    params = _jax_params(sd, jnp.float32)
    trainer = JT.YolactTrainer(JCFG, loss_cfg=JL.YolactLossConfig(**LOSS),
                               lr_fn=lambda it: LR,
                               compute_dtype=jnp.bfloat16, freeze_bn=True)
    _, _, losses = trainer.train_step(
        params, trainer.init_state(params), jnp.asarray(images),
        {k: jnp.asarray(v) for k, v in targets.items()}, KEY, 0)
    draws = torch.from_numpy(jax_draws(KEY, B, Y.make_priors_np(CFG)
                                       .shape[0]))
    out = {"jax": {k: float(v) for k, v in losses.items()}}
    # oneDNN's bf16 convolution backward on the CPU (torch 2.13) returns
    # garbage weight gradients, up to inf, for a stride-2 3x3 conv over a
    # 1x1 input: FastMaskIoUNet's fifth conv at this 64 canvas (at 550 its
    # input is 9x9; the card runs cuDNN). torch's own convolution is right.
    with torch.backends.mkldnn.flags(enabled=False):
        out["bf16"] = _port_step(_model(sd, True), images, targets, draws,
                                 torch.bfloat16)
    out["f32"] = _port_step(_model(sd, True), images, targets, draws, None)
    return out


def test_bf16_losses_match_yolact_trainer(steps):
    got, want = steps["bf16"]["losses"], steps["jax"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL.get(k, 1e-2),
                                   err_msg=k)


def test_bf16_masters_and_update_stay_f32(steps):
    model = steps["bf16"]["model"]
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
    for name, b in model.named_buffers():
        assert b.dtype in (torch.float32, torch.int64), name
    assert all(torch.isfinite(d).all() for d in steps["bf16"]["delta"]
               .values())


def test_bf16_update_follows_the_f32_update(steps):
    port, ref = steps["bf16"]["delta"], steps["f32"]["delta"]
    errs = []
    for name, r in ref.items():
        r = r.double()
        assert r.norm() > 0, name  # weight decay moves every parameter
        errs.append(float((port[name].double() - r).norm() / r.norm()))
        assert errs[-1] <= UPDATE_L2, (name, errs[-1])
    assert np.median(errs) <= UPDATE_L2_MEDIAN, np.median(errs)


def test_bf16_cast_updates_f32_running_statistics():
    """A train-mode BatchNorm under ``call_in_dtype(bf16)`` takes its batch
    statistics in f32 from the bf16 input (tpuseg's ``batch_norm`` under
    ``bn_train_mode``) and updates the module's own f32 running buffers,
    momentum 0.1 and the unbiased variance (``bn_apply_stats``), while its
    output is bf16 and its affine parameters get f32 gradients."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                              torch.nn.BatchNorm2d(4)).train()
    bn = net[1]
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    old_mean, old_var = bn.running_mean.clone(), bn.running_var.clone()
    x = torch.randn(2, 3, 9, 9) * 3
    y = TT.call_in_dtype(net, torch.bfloat16, lambda m, x: m(x),
                         x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    y.float().square().sum().backward()
    assert bn.weight.grad.dtype == torch.float32
    with torch.no_grad():
        h = torch.nn.functional.conv2d(
            x.to(torch.bfloat16), net[0].weight.to(torch.bfloat16),
            net[0].bias.to(torch.bfloat16)).float()
    n = h.numel() // 4
    mean = h.mean((0, 2, 3))
    var = h.var((0, 2, 3), unbiased=False) * n / (n - 1)
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    torch.testing.assert_close(bn.running_mean, 0.9 * old_mean + 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 * old_var + 0.1 * var)
    assert int(bn.num_batches_tracked) == 1
