"""tpuseg_torch's Pose2Seg training step against tpuseg's Pose2SegTrainer,
on the CPU, in f64: the loss, every gradient and the SGD step (momentum
0.9, weight decay 5e-4, lr 2e-4, the whole model in train mode) and the
BatchNorm running statistics, on the same numpy-seeded weights and batch.

The ResNet is narrowed to a stem width of 16 (``feature_channels`` 32, 2
seg units, a 128 canvas, 32x32 crops): tpuseg's f64 convolutions on the
CPU are slow. At 32 channels tpuseg's ``affine_align`` takes its gather
route, which samples in f32 inside the f64 step: so the loss meets rtol
1e-6, not f64's rounding.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pose2seg import WIDTH, heads_inputs, jax_tree
from tpuseg.models import pose2seg as JP
from tpuseg.models import pose2seg_loss as JL
from tpuseg_torch.models import pose2seg as TP
from tpuseg_torch.models import pose2seg_loss as TL
from tpuseg_torch.weights.from_jax import pose2seg_state_dict_from_jax

torch.set_num_threads(2)

CFG = dict(input_size=128, feature_channels=32, seg_units=2, align_size=32,
           max_people=2)
B = 2
LR = 2e-4
WD = 5e-4


def _batch(rng, cfg):
    images = rng.standard_normal((B, 128, 128, 3))
    xs = [heads_inputs(rng, cfg, 2) for _ in range(B)]
    theta = np.concatenate([x["theta"] for x in xs]).astype(np.float64)
    valid = np.concatenate([x["person_valid"] for x in xs])
    valid[1, 1] = False  # an empty slot
    skel = np.concatenate([x["skel"] for x in xs]).astype(np.float64)
    gt = (rng.uniform(0, 1, (B, 2, 32, 32)) < 0.4).astype(np.float64)
    return images, theta, valid, gt, skel


@pytest.fixture(scope="module")
def steps():
    cfg = TP.Pose2SegConfig(**CFG)
    rng = np.random.default_rng(7)
    tree = jax_tree(rng, cfg)
    images, theta, valid, gt, skel = _batch(rng, cfg)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        trainer = JL.Pose2SegTrainer(JP.Pose2SegConfig(**CFG))
        new, _, loss = trainer.train_step(
            params, trainer.init_state(params), jnp.asarray(images),
            jnp.asarray(theta), jnp.asarray(valid), jnp.asarray(gt), 0,
            skel=jnp.asarray(skel))
        delta = jax.tree.map(lambda a, b: a - b, new, params)
        # the first update is p' = p - lr (g + wd p)
        grad = jax.tree.map(lambda d, p: -d / LR - WD * p, delta, params)
        want = {"loss": float(loss)} | {
            k: pose2seg_state_dict_from_jax(jax.tree.map(np.asarray, t))
            for k, t in (("after", new), ("delta", delta), ("grad", grad))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "ResNetFPN", functools.partial(TP.ResNetFPN,
                                                       width=WIDTH))
        model = TP.build_model(cfg)
    model.load_state_dict(pose2seg_state_dict_from_jax(tree), strict=True)
    model = model.double()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tt = TL.Pose2SegTrainer(model)
    t = [torch.from_numpy(a) for a in (images, theta, valid, gt, skel)]
    t[0] = t[0].permute(0, 3, 1, 2)
    loss = tt.train_step(*t[:4], skel=t[4])
    got = {"loss": float(loss), "before": before,
           "after": model.state_dict(),
           "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}
    return got, want, tt


def test_loss_matches_tpuseg(steps):
    got, want, _ = steps
    assert np.isfinite(got["loss"]) and got["loss"] > 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)


UNUSED = ("backbone.smooth1.", "backbone.smooth2.")  # not on P2's path


def test_gradients_and_sgd_step_match_tpuseg(steps):
    """Every parameter: the gradient, recovered in f64 from tpuseg's first
    SGD update (p' = p - lr (g + wd p)), and the update itself, rtol 1e-3
    / atol 1e-5 max|g|. smooth1 and smooth2 get no gradient on either side
    (tpuseg's recovered one is rounding, below 1e-12 max|p|) and decay by
    the weight decay alone, as tpuseg's SGD decays them."""
    got, want, tt = steps
    assert tt.optimizer.defaults["momentum"] == 0.9
    names = [n for n, _ in tt.model.named_parameters()]
    assert len(names) == len(got["grads"]) > 100
    for n in names:
        tgrad, jgrad = got["grads"][n].numpy(), want["grad"][n].numpy()
        if n.startswith(UNUSED):
            assert not tgrad.any(), n
            p = got["before"][n].abs().max().item()
            assert np.abs(jgrad).max() <= 1e-12 * p, n
        else:
            np.testing.assert_allclose(tgrad, jgrad, rtol=1e-3,
                                       atol=1e-5 * np.abs(jgrad).max(),
                                       err_msg=f"grad {n}")
        tdelta = (got["after"][n] - got["before"][n]).numpy()
        jdelta = want["delta"][n].numpy()
        np.testing.assert_allclose(tdelta, jdelta, rtol=1e-3,
                                   atol=1e-5 * np.abs(jdelta).max(),
                                   err_msg=f"step {n}")
        assert np.abs(tdelta).max() > 0, n


def test_running_statistics_match_tpuseg(steps):
    """Each BatchNorm's running mean and variance after the step (momentum
    0.1, the unbiased batch variance), rtol 1e-4 / atol 1e-6."""
    got, want, _ = steps
    names = [k for k in got["after"] if k.endswith(("running_mean",
                                                    "running_var"))]
    assert len(names) > 100
    for k in names:
        assert not torch.equal(got["after"][k], got["before"][k]), k
        np.testing.assert_allclose(got["after"][k].numpy(),
                                   want["after"][k].double().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_step_needs_skeleton_features():
    """With cat_skeleton on, a step without skeleton features raises (the
    skeleton channels zeroed would train a segnet that never uses them)."""
    cfg = TP.Pose2SegConfig(**CFG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "ResNetFPN", functools.partial(TP.ResNetFPN,
                                                       width=WIDTH))
        model = TP.build_model(cfg, torch.Generator().manual_seed(0))
    tt = TL.Pose2SegTrainer(model)
    with pytest.raises(ValueError, match="skel"):
        tt.train_step(torch.zeros(1, 3, 128, 128), torch.zeros(1, 2, 2, 3),
                      torch.ones(1, 2, dtype=torch.bool),
                      torch.zeros(1, 2, 32, 32))
