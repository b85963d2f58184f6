"""The YOLACT++ training step of tpuseg_torch against tpuseg's
``YolactTrainer``: yolact_plus_resnet50 at full R-50 width (13 DCNv2
blocks, 256 FPN channels, 32 prototypes, FastMaskIoUNet) on a 64x64 canvas
with 4 classes (``tests/test_yolact_train.py::_tiny`` with ++'s backbone,
anchors and mask rescoring), B = 2. Weights from a numpy seed reach the
port through ``yolact_state_dict_from_jax``; the mask-subset draws are the
JAX package's own. Here the gradients, the SGD step, the lr schedule, the
checkpoints; the step with train-mode BatchNorm and ``train()`` in
``tests/test_torch_yolact_train_bn.py``.

The DCN offset convs are N(0, 1/fan) times 0.2 (``TRAIN_OFFSET_SCALE``,
as the smoke's training phase: offsets of ~0.2-0.4 px, every sample off
the integers, where the floor rule and the hat rule agree). With the
inference smoke's larger offsets (1.5-3.5 px) each DCN multiplies a
perturbation of its input by ~2 through its offsets, and the two packages'
f32 rounding grows through 13 of them to percents of the loss.

The step here runs with ``freeze_bn`` (BatchNorm in eval mode, its affine
parameters training: what ``train()`` does below a batch of 6), where the
gradients meet the JAX package's elementwise. In train mode the JAX
package's f32 DCNs (it samples and contracts them in f32 under x64) move a
pre-activation across a ReLU here and there, and BatchNorm's backward
spreads that over the channel: there the gradients are held by relative L2
error (``tests/test_torch_yolact_train_bn.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TRAIN_OFFSET_SCALE, synthetic_yolact_state_dict
from tests.test_torch_yolact_loss import jax_draws
from tpuseg.engine import trainer as JT
from tpuseg.models import yolact as JY
from tpuseg.models import yolact_loss as JL
from tpuseg.weights.yolact_map import from_torch_state
from tpuseg_torch.configs.presets import yolact_model_config
from tpuseg_torch.engine import trainer as TT
from tpuseg_torch.engine import yolact_train_loop as TL
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.models import yolact_loss as YL
from tpuseg_torch.weights.from_jax import yolact_state_dict_from_jax

# pytest-xdist runs several workers on the CPU's cores: more torch threads
# each would only oversubscribe them
torch.set_num_threads(2)

CFG = dataclasses.replace(yolact_model_config("yolact_plus_resnet50"),
                          img_size=64, num_classes=4, nms_top_k=8,
                          max_num_detections=5)
JCFG = JY.YolactConfig(**{f.name: getattr(CFG, f.name)
                          for f in dataclasses.fields(CFG)})
LOSS = dict(use_maskiou=True, masks_to_train=8)
B, G = 2, 8
SIZES = Y.level_sizes(CFG)
KEY = jax.random.PRNGKey(1)
LOSS_KEYS = ("B", "C", "M", "S", "I", "total")
WD = 5e-4


def assert_step_close(got: np.ndarray, want: np.ndarray, name: str) -> None:
    """A gradient or an update of the f64 step: rtol 1e-3 / atol 1e-5
    max|ref| elementwise (``tests/test_torch_maskrcnn_train.py``'s). A
    reference below 1e-10 is zero (a gradient recovered from the update,
    p / lr in f64 rounding), and so must the port's be."""
    scale = np.abs(want).max()
    if scale < 1e-10:
        assert np.abs(got).max() < 1e-10, name
        return
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * scale,
                               err_msg=name)


def _state_dict() -> dict:
    sd = synthetic_yolact_state_dict(Y.build_model(CFG), 3,
                                     offset_scale=TRAIN_OFFSET_SCALE)
    return {k: v.numpy() for k, v in sd.items()}


def _jax_params(sd: dict, dtype):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a, dtype),
                        from_torch_state(sd, JCFG),
                        is_leaf=lambda a: a is None or isinstance(a,
                                                                  np.ndarray))


def _np(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


def _inputs(rng):
    images = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    xy = rng.uniform(0, 0.5, (B, G, 2))
    wh = rng.uniform(0.2, 0.5, (B, G, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    classes = rng.integers(0, 3, (B, G)).astype(np.int32)
    classes[:, 6:] = -1  # padding
    crowd = np.zeros((B, G), bool)
    crowd[1, 5] = True
    p, s = 2 * SIZES[0], SIZES[0]
    return images, {
        "boxes": boxes, "classes": classes, "crowd": crowd,
        "masks_proto": (rng.uniform(size=(B, G, p, p)) > 0.5).astype(
            np.float32),
        "masks_sem": (rng.uniform(size=(B, G, s, s)) > 0.5).astype(
            np.float32)}


def _port_targets(targets: dict, dtype) -> dict:
    t = {k: torch.from_numpy(v) for k, v in targets.items()}
    t["classes"] = t["classes"].long()
    for k in ("boxes", "masks_proto", "masks_sem"):
        t[k] = t[k].to(dtype)
    return t


def jax_step64(sd, images, targets, freeze_bn: bool) -> dict:
    """One YolactTrainer step in float64 (its default schedule at iteration
    0): the losses, the parameters' gradients recovered from the first SGD
    step (a zero momentum buffer: delta = -lr (g + wd p)), the step and the
    parameters after it (in train mode with the running statistics that
    bn_apply_stats makes of the batch's)."""
    params = _jax_params(sd, jnp.float64)
    trainer = JT.YolactTrainer(JCFG, loss_cfg=JL.YolactLossConfig(**LOSS),
                               freeze_bn=freeze_bn)
    new, _, losses = trainer.train_step(
        params, trainer.init_state(params), jnp.asarray(images, jnp.float64),
        {k: jnp.asarray(v) for k, v in targets.items()}, KEY, 0)
    lr = float(trainer.lr_fn(0))
    old, new = _np(params), _np(new)
    delta = jax.tree.map(lambda n, o: n - o, new, old)
    grads = jax.tree.map(lambda d, o: -d / lr - WD * o, delta, old)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": yolact_state_dict_from_jax(grads, CFG),
            "delta": yolact_state_dict_from_jax(delta, CFG),
            "new": yolact_state_dict_from_jax(new, CFG), "lr": lr}


def port_model(sd: dict, dtype, freeze_bn: bool) -> Y.Yolact:
    model = Y.build_model(CFG)
    model.load_state_dict(yolact_state_dict_from_jax(
        _np(_jax_params(sd, jnp.float32)), CFG), strict=True)
    model.freeze_bn = freeze_bn
    return model.to(dtype).train()


def port_step(sd: dict, images, targets, draws, dtype,
              freeze_bn: bool) -> dict:
    """One step of the training loop's train_step on the port in ``dtype``
    at the schedule's iteration 0: its losses, every parameter's gradient,
    the model after the step and its state before."""
    model = port_model(sd, dtype, freeze_bn)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses = TL.train_step(
        model, TT.make_yolact_optimizer(model), TT.yolact_lr_schedule()(0),
        torch.from_numpy(images.transpose(0, 3, 1, 2).copy()).to(dtype),
        _port_targets(targets, dtype),
        torch.from_numpy(Y.make_priors_np(CFG)).to(dtype), draws,
        YL.YolactLossConfig(**LOSS))
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "model": model, "before": before}


@pytest.fixture(scope="module")
def step():
    rng = np.random.default_rng(11)
    sd = _state_dict()
    images, targets = _inputs(rng)
    n = Y.make_priors_np(CFG).shape[0]
    with jax.enable_x64(True):
        want = jax_step64(sd, images, targets, freeze_bn=True)
        draws = torch.from_numpy(jax_draws(KEY, B, n))  # f64 under x64

    # the port in f32: the training forward and the loss
    m32 = port_model(sd, torch.float32, freeze_bn=True)
    with torch.no_grad():
        preds, sem = m32.forward_train(
            torch.from_numpy(images.transpose(0, 3, 1, 2).copy()))
        l32 = YL.total_loss(preds, sem, _port_targets(targets, torch.float32),
                            torch.from_numpy(Y.make_priors_np(CFG)), draws,
                            YL.YolactLossConfig(**LOSS), m32.maskiou_net)
    # the port in f64: one step of the training loop's train_step
    got = port_step(sd, images, targets, draws, torch.float64,
                    freeze_bn=True)
    got.update(losses32={k: float(v) for k, v in l32.items()}, model32=m32)
    return {"jax": want, "port": got}


@pytest.mark.parametrize("which,rtol", [("losses32", 1e-4),
                                        ("losses", 1e-5)])
def test_losses_match_jax_term_by_term(step, which, rtol):
    """The port in f32 and in f64 against the YolactTrainer step's losses
    (f64, its DCNs in f32), on the same draws: f32 rtol 1e-4; f64 rtol
    1e-5, the JAX package's f32 DCNs (measured 2e-6)."""
    got, want = step["port"][which], step["jax"]["losses"]
    assert tuple(got) == LOSS_KEYS and set(want) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        assert np.isfinite(got[k]) and got[k] > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_gradients_match_yolact_trainer(step):
    """Every parameter's gradient in f64, BatchNorm's affine parameters
    included (see assert_step_close)."""
    port, want = step["port"], step["jax"]["grads"]
    names = [n for n, _ in port["model"].named_parameters()]
    assert sorted(port["grads"]) == sorted(names)
    assert sum("conv_offset_mask" in n for n in names) == 26
    for name in names:
        assert_step_close(port["grads"][name].numpy(), want[name].numpy(),
                          name)


def test_sgd_step_matches_yolact_trainer(step):
    """The update lr (g + wd p) on every parameter, held as its gradient
    is; with frozen BatchNorm no running statistic moves, on either side."""
    port, jx = step["port"], step["jax"]
    model, before = port["model"], port["before"]
    for name, p in model.named_parameters():
        assert_step_close((p.detach() - before[name]).numpy(),
                          jx["delta"][name].numpy(), name)
    sd = model.state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 53
    for k in stats:
        assert torch.equal(sd[k], before[k]), k
        np.testing.assert_array_equal(jx["new"][k].numpy(),
                                      before[k].float().numpy(), err_msg=k)


def test_lr_schedule_matches_jax():
    got, want = TT.yolact_lr_schedule(), JT.yolact_lr_schedule()
    for it in (0, 1, 250, 499, 500, 279999, 280000, 650000, 760000):
        np.testing.assert_allclose(got(it), float(want(it)), rtol=1e-6,
                                   err_msg=str(it))


def test_checkpoint_naming_and_round_trip(step, tmp_path):
    """``<cfg>_<epoch>_<iter>.pth``; the port's checkpoint loads back into
    the port with strict=True and through tpuseg's load_params_ckpt to the
    same values."""
    path = TT.ckpt_path(str(tmp_path), "yolact_plus_resnet50", 3, 1234)
    assert path.endswith("yolact_plus_resnet50_3_1234.pth")
    assert TT.parse_ckpt_iter(path) == 1234 == JT.parse_ckpt_iter(path)
    for bad in ("yolact.pth", "yolact_plus_resnet50_3_1234.npz"):
        with pytest.raises(ValueError):
            TT.parse_ckpt_iter(str(tmp_path / bad))
    model = step["port"]["model32"]
    TT.save_yolact_checkpoint(path, model)
    sd = {k: v for k, v in model.state_dict().items()}
    fresh = Y.build_model(CFG)
    fresh.load_state_dict(torch.load(path, weights_only=True), strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    params = JT.load_params_ckpt(path, None, JCFG)
    back = yolact_state_dict_from_jax(_np(params), CFG)
    floats = [k for k in sd if not k.endswith("num_batches_tracked")]
    assert sorted(back) == sorted(sd)
    for k in floats:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(),
                                      err_msg=k)
