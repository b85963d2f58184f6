"""The YOLACT++ training step of tpuseg_torch with BatchNorm in train mode
(batch statistics; ``freeze_bn=False``, what ``train()`` does from a batch
of 6) against ``YolactTrainer(freeze_bn=False)`` in float64, on the model,
weights, inputs and draws of ``tests/test_torch_yolact_train.py``: the
losses term by term, every parameter's gradient and the SGD step, and the
running statistics after the step. And ``train()`` itself on the CPU: its
console line, checkpoints, resume and frozen BatchNorm below a batch of 6.

The gradients are held per parameter by relative L2 error, at 5e-2. Under
x64 the JAX package still samples and contracts each DCN in f32
(``tpuseg/ops/deform_conv.py``); that rounding moves a pre-activation
across a ReLU here and there, and train-mode BatchNorm's backward spreads
the change over the whole channel. Measured here: the port in f64 against
tpuseg, median 5.6e-3 and largest 1.0e-2 over the 227 parameters whose
gradient is not zero (with frozen BatchNorm, ``test_torch_yolact_train.py``:
1e-7). The port's own f32 step against its f64 step shows the same spread
(median 5.9e-3, largest 3.1e-2; frozen: 3.8e-7 and 2.1e-6), so it is f32
rounding, not a fault. An O(1) fault in BatchNorm's batch-statistics
backward fails the limit on every backbone parameter."""
import re

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_yolact_loss import jax_draws
from tests.test_torch_yolact_train import (B, CFG, KEY, LOSS_KEYS, _inputs,
                                           _state_dict, jax_step64,
                                           port_step)
from tpuseg_torch.configs.presets import yolact_loss_config
from tpuseg_torch.engine import yolact_train_loop as TL
from tpuseg_torch.models import yolact as Y

# pytest-xdist runs several workers on the CPU's cores: more torch threads
# each would only oversubscribe them
torch.set_num_threads(2)

REL_L2 = 5e-2


def assert_rel_l2(got: dict, want: dict, limit: float, zero: float) -> None:
    """Every leaf's ||got - want|| / ||want|| within ``limit``. A leaf
    whose reference is zero to rounding (max|want| <= 1e-10 of the largest
    |want| of all: a conv's bias in front of a train-mode BatchNorm, which
    its batch mean cancels; FPN levels this canvas leaves unused) must be
    zero in ``got`` to ``zero`` of that largest |want|."""
    scale = max(np.abs(w).max() for w in want.values())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if np.abs(w).max() <= 1e-10 * scale:
            assert np.abs(g).max() <= zero * scale, name
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= limit, (name, err)


@pytest.fixture(scope="module")
def step():
    rng = np.random.default_rng(11)
    sd = _state_dict()
    images, targets = _inputs(rng)
    with jax.enable_x64(True):
        want = jax_step64(sd, images, targets, freeze_bn=False)
        draws = torch.from_numpy(jax_draws(KEY, B, Y.make_priors_np(CFG)
                                           .shape[0]))
    port32, port = (port_step(sd, images, targets, draws, dt,
                              freeze_bn=False)
                    for dt in (torch.float32, torch.float64))
    port["losses32"] = port32["losses"]
    return {"jax": want, "port": port, "port32": port32}


def _np(tree: dict) -> dict:
    return {k: v.double().numpy() for k, v in tree.items()}


@pytest.mark.parametrize("which,rtol", [("losses32", 1e-4),
                                        ("losses", 1e-5)])
def test_train_mode_losses_match_jax(step, which, rtol):
    """The port in f32 and in f64 against tpuseg's f64 (its DCNs in f32),
    on the same draws."""
    got, want = step["port"][which], step["jax"]["losses"]
    assert tuple(got) == LOSS_KEYS and set(want) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        assert np.isfinite(got[k]) and got[k] > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("what", ["grads", "delta"])
def test_train_mode_step_matches_yolact_trainer(step, what):
    """Every parameter's gradient, and its update lr (g + wd p), in f64
    against YolactTrainer's, to 5e-2 relative L2 (see the module's note)."""
    port, want = step["port"], step["jax"][what]
    names = [n for n, _ in port["model"].named_parameters()]
    assert sorted(port["grads"]) == sorted(names)
    if what == "grads":
        got = port["grads"]
    else:
        got = {n: p.detach() - port["before"][n]
               for n, p in port["model"].named_parameters()}
    assert_rel_l2(_np(got), _np({n: want[n] for n in names}), REL_L2,
                  zero=1e-10)


def test_train_mode_f32_step_agrees_with_f64(step):
    """The port's f32 step against its own f64 step: the gradients to 1e-1
    relative L2 (measured: median 5.9e-3, largest 3.1e-2, f32 rounding
    through train-mode BatchNorm); zero gradients zero to 1e-6 of the
    largest (measured 2.5e-8)."""
    assert_rel_l2(_np(step["port32"]["grads"]), _np(step["port"]["grads"]),
                  1e-1, zero=1e-6)


def test_running_statistics_match_jax(step):
    """Every BatchNorm's running mean and variance after the step (f64) to
    rtol 1e-4 / atol 1e-4 max|ref|: the batch statistics are forward
    values, carried through the JAX package's f32 DCNs (measured within
    1e-5 of max|ref|)."""
    model, before = step["port"]["model"], step["port"]["before"]
    sd = model.state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 53
    for k in stats:
        assert not torch.equal(sd[k], before[k]), k
        want = step["jax"]["new"][k].numpy()
        np.testing.assert_allclose(sd[k].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


class _Dataset:
    """Four 90x120 RGB images with five elliptic masks each."""

    def __init__(self, n=4, h=90, w=120, g=5):
        rng = np.random.default_rng(0)
        self.image_ids = list(range(n))
        self._data = {}
        yy, xx = np.mgrid[:h, :w]
        for i in self.image_ids:
            wh = rng.uniform(0.2, 0.5, (g, 2)) * [w, h]
            xy = rng.uniform(0, 1, (g, 2)) * ([w, h] - wh)
            boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
            masks = np.stack([((xx - (a + c) / 2) / ((c - a) / 2)) ** 2
                              + ((yy - (b + d) / 2) / ((d - b) / 2)) ** 2 <= 1
                              for a, b, c, d in boxes]).astype(np.uint8)
            self._data[i] = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                             {"boxes": boxes,
                              "classes": rng.integers(0, 3, g),
                              "masks": masks, "iscrowd": np.zeros(g, int)})

    def load_image(self, i):
        return self._data[i][0].copy()

    def load_target(self, i):
        return {k: v.copy() for k, v in self._data[i][1].items()}


def test_train_loop_logs_saves_and_resumes(tmp_path, capsys):
    """train() on the CPU: B = 2 (< 6: BatchNorm frozen, its affine
    parameters train, its statistics stay), the B/C/M/S/I console line,
    ``<cfg>_<epoch>_<iter>.pth`` checkpoints, and a resume that continues
    from the checkpoint's iteration."""
    data = _Dataset()
    model = Y.build_model(CFG, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model, it, hist = TL.train(data, CFG, batch_size=2, max_steps=2,
                               save_every=2, save_folder=str(tmp_path),
                               cfg_name="tiny", log_every=1,
                               loss_cfg=yolact_loss_config(
                                   "yolact_plus_resnet50"),
                               model=model, device="cpu")
    assert it == 2 and len(hist) == 2 and model.freeze_bn
    assert all(np.isfinite(v) for h in hist for v in h.values())
    out = capsys.readouterr().out
    assert re.search(r"\[  1\]       2 \|\| B: .* \| C: .* \| M: .* \| "
                     r"S: .* \| I: .* \|\| T: .* \|\| ETA: .*h \|\| .*s/it",
                     out), out
    path = tmp_path / "tiny_1_2.pth"
    assert f"saved {path}" in out
    after = model.state_dict()
    for k, v in after.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert torch.equal(v, before[k]), k
    assert not torch.equal(after["backbone.bn1.weight"],
                           before["backbone.bn1.weight"])
    _, it2, _ = TL.train(data, CFG, batch_size=2, max_steps=1,
                         save_every=100, resume=str(path), log_every=100,
                         device="cpu")
    assert it2 == 3
