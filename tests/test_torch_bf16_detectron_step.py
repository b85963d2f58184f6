"""The Mask R-CNN R-50-FPN training step in bf16 mixed precision
(``engine/trainer.py::call_in_dtype``, what ``train_step(compute_dtype=
bfloat16)`` runs) against tpuseg's forward in its mixed precision
(``cast_floats`` of the f32 params and a bf16 image batch, as its
``do_train(compute_dtype=bfloat16)``): a ResNet stem width of 16, 9
classes, a 128x192 canvas, the JAX package's own sampler draws.

Held: the losses term by term against tpuseg's (measured on the CPU:
within 8.9e-3 relative, loss_box_reg; held at 2e-2); the master
parameters, their gradients and the SGD update stay f32; and each
trainable parameter's update against the port's own f32 update on the
same batch, by relative L2 (measured: median 0.19, largest 0.32, at
layer4's first conv; held at 0.3 and 0.6). The bf16 update is not held
against tpuseg's: on this batch tpuseg's lies at a median 0.12 from the
port's f32 update, but its mask-head biases at 0.38-0.62, the port's at
0.16-0.24; neither is the other's reference.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_state_dict
from tests.test_cross_parity import NC
from tests.test_torch_maskrcnn_loss import jax_draws_per_image
from tpuseg.engine import trainer as JT
from tpuseg.models import maskrcnn as JM
from tpuseg.models import maskrcnn_loss as JL
from tpuseg.weights.detectron_map import from_torch_state
from tpuseg_torch.engine import trainer as TT
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import maskrcnn_loss as TL
from tpuseg_torch.nn.resnet import ResNet

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

CANVAS = (128, 192)
IMAGE_HW = np.array([CANVAS, (100, 150)], np.int64)
G = 6
CFG_KW = dict(num_classes=NC, rpn_pre_nms_top_n_train=300,
              fpn_post_nms_top_n_train=200)
LOSS_KW = dict(num_classes=NC, rpn_batch_per_image=64, roi_batch_per_image=64)
LR = 0.0025 / 3  # WarmupMultiStepLR at iteration 0
LOSS_RTOL = 2e-2
UPDATE_L2 = 0.6  # any parameter's bf16 update against its f32 update
UPDATE_L2_MEDIAN = 0.3


def _inputs(rng):
    images = np.zeros((2, 3, *CANVAS), np.float32)
    boxes = np.zeros((2, G, 4), np.float32)
    for i, (h, w) in enumerate(IMAGE_HW):
        images[i, :, :h, :w] = rng.standard_normal((3, h, w)) * 40.0
        xy = rng.uniform(0, [w * 0.6, h * 0.6], (G, 2))
        boxes[i] = np.concatenate(
            [xy, xy + rng.uniform(16, [w * 0.4, h * 0.4], (G, 2))], -1)
    classes = rng.integers(0, NC - 1, (2, G)).astype(np.int32)
    classes[1, 4:] = -1
    crops = (rng.uniform(size=(2, G, 32, 32)) > 0.4).astype(np.float32)
    return images, {"boxes": boxes, "classes": classes, "mask_crops": crops}


def _jax_losses(sd, images, targets):
    key = jax.random.PRNGKey(5)
    jcfg = JM.MaskRCNNConfig(**CFG_KW)
    params = jax.tree.map(jnp.asarray, from_torch_state(sd, jcfg))
    losses = jax.jit(lambda p: JM.forward_train_losses(
        JT.cast_floats(p, jnp.bfloat16),
        jnp.asarray(images.transpose(0, 2, 3, 1)).astype(jnp.bfloat16),
        jnp.asarray(IMAGE_HW.astype(np.int32)),
        {k: jnp.asarray(v) for k, v in targets.items()}, key, jcfg,
        JL.MaskRCNNLossConfig(**LOSS_KW)))(params)
    cfg = M.MaskRCNNConfig(**CFG_KW)
    k_rpn, k_roi = jax.random.split(key)
    n_anchors = sum(a.shape[0] for a in M.make_anchors_np(cfg, *CANVAS))
    return {"losses": {k: float(v) for k, v in losses.items()},
            "draws": {"rpn": jax_draws_per_image(k_rpn, 2, n_anchors),
                      "roi": jax_draws_per_image(
                          k_roi, 2, cfg.fpn_post_nms_top_n_train + G)}}


def _port_step(model, images, targets, draws, dtype) -> dict:
    model.train()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = TT.call_in_dtype(
        model, dtype, M.forward_train_losses, torch.from_numpy(images).to(
            dtype or torch.float32), torch.from_numpy(IMAGE_HW),
        {k: torch.from_numpy(v) for k, v in targets.items()}, draws=draws,
        loss_cfg=TL.MaskRCNNLossConfig(**LOSS_KW))
    opt = TT.make_optimizer(model, 0.0025)
    TT.set_lr(opt, LR)
    opt.zero_grad()
    losses["total"].backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    opt.step()
    return {"losses": {k: float(v.detach()) for k, v in losses.items()},
            "grads": grads,
            "delta": {n: p.detach() - before[n]
                      for n, p in model.named_parameters()
                      if p.requires_grad},
            "params": dict(model.named_parameters())}


@pytest.fixture(scope="module")
def steps():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "ResNet", functools.partial(ResNet, width=16))
        cfg = M.MaskRCNNConfig(**CFG_KW)
        sd = synthetic_state_dict(M.build_model(cfg), 31)
        models = [M.build_model(cfg) for _ in range(2)]
    for m in models:
        m.load_state_dict(sd, strict=True)
    images, targets = _inputs(np.random.default_rng(17))
    want = _jax_losses({k: v.numpy() for k, v in sd.items()}, images,
                       targets)
    bf16 = _port_step(models[0], images, targets, want["draws"],
                      torch.bfloat16)
    f32 = _port_step(models[1], images, targets, want["draws"], None)
    return {"jax": want, "bf16": bf16, "f32": f32}


def test_bf16_losses_match_jax(steps):
    got, want = steps["bf16"]["losses"], steps["jax"]["losses"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.isfinite(got[k]) and got[k] > 0, k
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)


def test_bf16_masters_gradients_and_update_stay_f32(steps):
    port = steps["bf16"]
    assert all(p.dtype == torch.float32 for p in port["params"].values())
    assert port["grads"] and all(g.dtype == torch.float32
                                 for g in port["grads"].values())
    assert sorted(port["grads"]) == sorted(port["delta"])
    assert all(torch.isfinite(d).all() for d in port["delta"].values())


def test_bf16_update_follows_the_f32_update(steps):
    port, ref = steps["bf16"]["delta"], steps["f32"]["delta"]
    assert port.keys() == ref.keys()
    errs = []
    for name, r in ref.items():
        r = r.double()
        if r.norm() == 0:  # P6's conv: no roi reads P6 at this canvas
            assert port[name].abs().max() == 0, name
            continue
        errs.append(float((port[name].double() - r).norm() / r.norm()))
        assert errs[-1] <= UPDATE_L2, (name, errs[-1])
    assert len(errs) >= 80
    assert np.median(errs) <= UPDATE_L2_MEDIAN, np.median(errs)
