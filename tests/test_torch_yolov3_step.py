"""tpuseg_torch's YOLOv3 training step against tpuseg's, on the CPU, in
f64 at full width (DarkNet-53, 80 classes, a 64 px letterbox, B = 1, the
port's random init carried to tpuseg's tree): the step
``tools/yolo_train.py`` builds (train-mode BatchNorm, SGD with momentum 0.9
and weight decay 5e-4 on every leaf but the running statistics, the
burn-in) against ``YoloTrainer.train_step``: the losses, every gradient,
the SGD update and the BatchNorm running statistics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_yolov3_train import gts
from tpuseg.engine.trainer import sgd_init, sgd_update
from tpuseg.models import yolov3 as JY
from tpuseg.models import yolov3_loss as JL
from tpuseg.nn import layers as L
from tpuseg_torch.engine.yolo_engine import YoloTrainer
from tpuseg_torch.models import yolov3 as TY
from tpuseg_torch.ops.preprocess import letterbox_preprocess
from tpuseg_torch.weights.from_jax import yolov3_jax_from_state_dict
from tpuseg_torch.weights.npz_io import flatten_params

torch.set_num_threads(2)

SIZE = 64  # heads at 2x2, 4x4, 8x8; C5's BatchNorm sees 4 values a channel
LR = 1e-3
IT = 499  # the burn-in's lr: LR * 0.5


def port_keyed(tree) -> dict:
    """tpuseg's tree under the port's keys in f64 (conv kernels HWIO ->
    OIHW): ``yolov3_state_dict_from_jax`` without its rounding to f32."""
    return {k: np.ascontiguousarray(v.transpose(3, 2, 0, 1)) if v.ndim == 4
            else v for k, v in flatten_params(jax.tree.map(np.asarray,
                                                    tree)).items()}


@pytest.fixture(scope="module")
def steps():
    """One step of each package in f64 from the same weights (the port's
    random init, seed 5, carried to tpuseg's tree) and batch."""
    cfg = TY.YoloV3Config(input_size=SIZE)
    jcfg = JY.YoloV3Config(input_size=SIZE)
    rng = np.random.default_rng(2)
    hw = np.asarray([[70, 96]], np.int32)
    images = np.zeros((1, 96, 96, 3), np.uint8)
    images[0, :70] = rng.integers(0, 256, (70, 96, 3))
    boxes, classes = gts(rng, 1, 8, SIZE)
    sd = TY.build_model(cfg, torch.Generator().manual_seed(5)).state_dict()
    tree = yolov3_jax_from_state_dict(sd)
    # the letterbox is held against tpuseg's in tests/test_torch_yolov3.py
    # (within 2e-6): here both steps start from its f32 output, bit for
    # bit, since the network in f64 turns the last bit of its input into
    # leaky-ReLU kinks crossed and rtol 1e-6 of the loss
    x = letterbox_preprocess(torch.from_numpy(images), torch.from_numpy(hw),
                             size=SIZE).permute(0, 2, 3, 1).numpy()
    with jax.enable_x64(True):
        params = jax.device_put(jax.tree.map(
            lambda a: a.astype(np.float64), tree))

        def step(params, x, gt_boxes, gt_classes, it):
            def loss_fn(p):
                with L.bn_train_mode() as bt:
                    outs = JY.forward(p, x, jcfg)
                losses = JL.total_loss(outs, gt_boxes, gt_classes, jcfg)
                return losses["total"], (losses, L.bn_tape_by_path(p,
                                                                   bt.tape))

            (_, (losses, stats)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            lr = LR * jnp.minimum(1.0, (it + 1) / 1000)
            new, _ = sgd_update(params, grads, sgd_init(params), lr, 0.9,
                                5e-4, lr_scale=L.bn_param_groups(params))
            new = L.bn_apply_stats(new, stats)
            delta = jax.tree.map(lambda a, b: a - b, new, params)
            return new, delta, grads, losses

        new, delta, grads, losses = jax.jit(step)(
            params, jnp.asarray(x, jnp.float64),
            jnp.asarray(boxes, jnp.float64), jnp.asarray(classes), IT)
        want = {"losses": {k: float(v) for k, v in losses.items()},
                **{k: port_keyed(t) for k, t in (("after", new),
                                                 ("delta", delta),
                                                 ("grad", grads))}}
    trainer = YoloTrainer(cfg, state_dict=sd, lr=LR, device="cpu")
    trainer.model.double()
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    out = trainer.train_step(torch.from_numpy(images), torch.from_numpy(hw),
                             torch.from_numpy(boxes), torch.from_numpy(classes),
                             IT)
    got = {"losses": {k: float(v) for k, v in out.items()}, "before": before,
           "after": trainer.model.state_dict(),
           "grads": {n: p.grad.clone()
                     for n, p in trainer.model.named_parameters()}}
    return got, want


def test_step_losses_match_tpuseg(steps):
    got, want = steps
    assert got["losses"].keys() == want["losses"].keys()
    for k, v in want["losses"].items():
        assert np.isfinite(v) and v > 0, k
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-6, err_msg=k)


def test_step_gradients_and_sgd_update_match_tpuseg(steps):
    """Every parameter (conv kernels, BatchNorm scales and shifts, the
    heads' biases): the gradient and the update, rtol 1e-3 / atol 1e-5
    max|g|."""
    got, want = steps
    assert len(got["grads"]) == 3 * 72 + 6  # 72 conv-BN layers, 3 heads
    for n, g in got["grads"].items():
        jg = want["grad"][n]
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-3,
                                   atol=1e-5 * np.abs(jg).max(),
                                   err_msg=f"grad {n}")
        delta = (got["after"][n] - got["before"][n]).numpy()
        jdelta = want["delta"][n]
        np.testing.assert_allclose(delta, jdelta, rtol=1e-3,
                                   atol=1e-5 * np.abs(jdelta).max(),
                                   err_msg=f"step {n}")
        assert np.abs(delta).max() > 0, n


def test_step_running_statistics_match_tpuseg(steps):
    """Each BatchNorm's running mean and variance after the step
    (momentum 0.1, the unbiased batch variance), rtol 1e-4."""
    got, want = steps
    names = [k for k in got["after"]
             if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 72
    for k in names:
        assert not torch.equal(got["after"][k], got["before"][k]), k
        np.testing.assert_allclose(got["after"][k].numpy(),
                                   want["after"][k],
                                   rtol=1e-4, atol=1e-7, err_msg=k)
