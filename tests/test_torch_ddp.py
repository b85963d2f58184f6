"""The port's data-parallel YOLACT training step (``tpuseg_torch/parallel/
ddp.py``, ``sync_bn.py``, the losses' global normalisers) on 2 gloo ranks
of the CPU in f64, against the port's one-process step and tpuseg's
single-device step, with ``tests/test_parallel.py``'s config, weights
(tpuseg's ``init_params``), inputs and draws:

- YOLACT (``test_yolact_train_step_identity_1v8``'s config), B = 8 as
  2 x 4 with train-mode BatchNorm synchronised: against the port's one
  process within 1e-9 (losses, every gradient, the running statistics),
  against tpuseg's step at ``tests/test_torch_yolact_train_bn.py``'s
  tolerances;
- at world size 1, DDP over gloo bit-equal to the plain step.

Mask R-CNN, the collectives and a bf16 step:
``tests/test_torch_ddp_maskrcnn.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_ranks
from tests.test_parallel import _yolact_train_batch
from tests.test_torch_yolact_loss import jax_draws
from tests.test_torch_yolact_train_bn import assert_rel_l2
from tpuseg.engine.trainer import YolactTrainer
from tpuseg.models import yolact as JY
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.parallel import ddp
from tpuseg_torch.weights.from_jax import yolact_state_dict_from_jax

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

YOLACT_KW = dict(img_size=64, num_classes=4, nms_top_k=8,
                 max_num_detections=5)
WD = 5e-4


def _tree(params):
    return jax.tree.map(np.asarray, params)


def assert_tree_close(got: dict, want: dict, rtol: float, atol: float,
                      what: str) -> None:
    """Every tensor within rtol, and atol times its own max|want| (values
    near zero by cancellation carry the summands' rounding)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].double()
        w = w.double()
        scale = max(float(w.abs().max()), 1e-300)
        assert torch.allclose(g, w, rtol=rtol, atol=atol * scale), (
            what, k, float((g - w).abs().max()) / scale)


@pytest.fixture(scope="module")
def yolact(tmp_path_factory):
    """tpuseg's single-device f64 step, the port's one-process step and
    its step on 2 gloo ranks, on the same weights, batch and draws."""
    jcfg = JY.YolactConfig(**YOLACT_KW)
    cfg = Y.YolactConfig(**YOLACT_KW)
    params32 = jax.jit(lambda k: JY.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    sd = {k: v.double() for k, v in yolact_state_dict_from_jax(
        _tree(params32), cfg).items()}
    n = Y.make_priors_np(cfg).shape[0]
    with jax.enable_x64(True):
        images, targets = _yolact_train_batch(np.random.default_rng(0), jcfg,
                                              b=8, dtype=np.float64)
        images, targets = np.asarray(images), _tree(targets)
        draws = torch.from_numpy(jax_draws(jax.random.PRNGKey(1), 8, n))
    t = {k: torch.from_numpy(np.array(v)) for k, v in targets.items()}
    t["classes"] = t["classes"].long()
    inp = {"cfg": cfg, "dtype": torch.float64, "state": sd,
           "images": torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
           "targets": t, "draws": draws}
    ranks = torch_ranks.start("yolact_step", 2,
                              tmp_path_factory.mktemp("yolact"), inp)
    with jax.enable_x64(True):
        params = jax.tree.map(
            lambda v: v.astype(jnp.float64)
            if jnp.issubdtype(v.dtype, jnp.floating) else v, params32)
        trainer = YolactTrainer(jcfg)
        new, _, losses = trainer.train_step(
            params, trainer.init_state(params), jnp.asarray(images),
            jax.tree.map(jnp.asarray, targets), jax.random.PRNGKey(1), 0)
        lr = float(trainer.lr_fn(0))
        old, new = _tree(params), _tree(new)
        grads = jax.tree.map(lambda nw, o: -(nw - o) / lr - WD * o, new, old)
        want = {"losses": {k: float(v) for k, v in losses.items()},
                "grads": yolact_state_dict_from_jax(grads, cfg),
                "new": yolact_state_dict_from_jax(new, cfg)}
    one = torch_ranks.yolact_step(inp)
    return {"jax": want, "one": one, "ranks": ranks.wait(timeout=240),
            "inp": inp, "tmp": tmp_path_factory.mktemp("yolact1")}


def test_yolact_two_ranks_match_one_process(yolact):
    one = yolact["one"]
    for r in yolact["ranks"]:
        for k, v in one["losses"].items():
            assert abs(r["losses"][k] - v) <= 1e-9 * abs(v), k
        assert_tree_close(r["grads"], one["grads"], 1e-9, 1e-10, "grads")
        assert_tree_close(
            {k: v for k, v in r["buffers"].items() if v.is_floating_point()},
            {k: v for k, v in one["buffers"].items()
             if v.is_floating_point()}, 1e-9, 1e-10, "running statistics")
    moved = [k for k, v in one["buffers"].items()
             if k.endswith("running_var") and not torch.equal(
                 v, yolact["inp"]["state"][k])]
    assert moved, "train-mode BatchNorm updated no running statistics"


def test_yolact_two_ranks_match_tpuseg(yolact):
    """Against tpuseg's single-device step: losses rtol 1e-5, gradients by
    relative L2 per parameter at 5e-2, zero ones zero to 1e-6 of the
    largest (``tests/test_torch_yolact_train_bn.py``), the running
    statistics at rtol 1e-6."""
    got, want = yolact["ranks"][0], yolact["jax"]
    assert set(got["losses"]) == set(want["losses"])
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-5, err_msg=k)
    assert_rel_l2({k: v.numpy() for k, v in got["grads"].items()},
                  {k: np.asarray(v) for k, v in want["grads"].items()
                   if k in got["grads"]}, 5e-2, zero=1e-6)
    for k, v in want["new"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["buffers"][k].numpy(),
                                       np.asarray(v), rtol=1e-6, atol=1e-12,
                                       err_msg=k)


def test_ddp_at_world_size_1_is_bit_equal(yolact):
    """The normalisers and DDP at world size 1 over gloo: the losses and
    every gradient bit for bit the plain step's."""
    (got,) = torch_ranks.spawn("yolact_step", 1, yolact["tmp"],
                               yolact["inp"], timeout=120)
    one = yolact["one"]
    assert got["losses"] == one["losses"]
    for k, v in one["grads"].items():
        assert torch.equal(got["grads"][k], v), k
    count = torch.tensor(0)
    assert torch.equal(ddp.denominator(count, 1), count.clamp(min=1))
    assert ddp.denominator(7) == 7
