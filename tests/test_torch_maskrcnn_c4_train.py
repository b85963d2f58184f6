"""The Mask R-CNN and Faster R-CNN R-50-C4 training step of tpuseg_torch
against tpuseg's maskrcnn_c4.forward_train_losses, jax.grad and
sgd_update, on the JAX package's own draws: the losses term by term in f32
and f64, the gradients and the SGD step in f64. A ResNet width of 16 (the
same code and shapes but for the channel counts; the upstream-keyed
synthetic weights of chip_smoke), so that the JAX package's f64 CPU
convolutions run in seconds (its 3x3 1024-channel RPN conv alone takes
~11 s at full width); 9 classes, 224x320 canvas, small budgets."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cross_parity_c4 import CANVAS
from tests.test_torch_maskrcnn_c4 import CFG_KW, _jax_params, _model
from tests.test_torch_maskrcnn_loss import jax_draws_per_image
from tests.test_torch_maskrcnn_train import (IMAGE_HW, LR, _inputs,
                                             assert_grad_close)
from tpuseg.engine import trainer as JT
from tpuseg.models import maskrcnn_c4 as JC4
from tpuseg.models import maskrcnn_loss as JL
from tpuseg_torch.engine import trainer as TT
from tpuseg_torch.models import maskrcnn_c4 as C4
from tpuseg_torch.models import maskrcnn_loss as TL
from tpuseg_torch.nn.resnet import ResNet
from tpuseg_torch.weights.from_jax import c4_state_dict_from_jax

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

LOSS_KW = dict(num_classes=CFG_KW["num_classes"], rpn_batch_per_image=64,
               roi_batch_per_image=16, mask_size=14)
LOSS_KEYS = ("loss_rpn_box_reg", "loss_objectness", "loss_classifier",
             "loss_box_reg", "loss_mask", "total")
WIDTH = 16  # the ResNet's stem width


def _jax_step(sd, images, targets, dtype, grad: bool) -> dict:
    """The JAX package's C4 step in ``dtype`` (call under jax.enable_x64
    for f64): losses, its draws and, with ``grad``, the gradients and the
    SGD update (one jitted program) as port state dicts."""
    key = jax.random.PRNGKey(5)
    jcfg = JC4.MaskRCNNC4Config(**CFG_KW)
    lcfg = JL.MaskRCNNLossConfig(**LOSS_KW)
    params = _jax_params(sd, jcfg, dtype)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def loss_fn(p):
        losses = JC4.forward_train_losses(
            p, jnp.asarray(images.transpose(0, 2, 3, 1), dtype),
            jnp.asarray(IMAGE_HW.astype(np.int32)), jt, key, jcfg, lcfg)
        return losses["total"], losses

    k_rpn, k_roi = jax.random.split(key)
    n_anchors = JC4.make_anchors_np(jcfg, *CANVAS).shape[0]
    g = targets["boxes"].shape[1]
    out = {"draws": {"rpn": jax_draws_per_image(k_rpn, 2, n_anchors),
                     "roi": jax_draws_per_image(
                         k_roi, 2, jcfg.rpn_post_nms_top_n_train + g)}}
    if not grad:
        _, jl = jax.jit(loss_fn)(params)
        out["losses"] = {k: float(v) for k, v in jl.items()}
        return out
    ls, ws = JT.detectron_param_groups(params)

    def step(p):
        (_, losses), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        new, _ = JT.sgd_update(p, g, JT.sgd_init(p), LR, momentum=0.9,
                               weight_decay=1e-4, lr_scale=ls, wd_scale=ws)
        return losses, g, jax.tree.map(lambda a, b: a - b, new, p)

    jl, jg, delta = jax.jit(step)(params)
    out.update(losses={k: float(v) for k, v in jl.items()},
               grads=c4_state_dict_from_jax(jax.tree.map(np.asarray, jg)),
               delta=c4_state_dict_from_jax(jax.tree.map(np.asarray, delta)))
    return out


def _torch_step(sd, cfg, images, targets, draws, dtype, grad: bool) -> dict:
    model = _model(sd, cfg).to(dtype)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.set_grad_enabled(grad):
        tl = C4.forward_train_losses(
            model, torch.from_numpy(images).to(dtype),
            torch.from_numpy(IMAGE_HW),
            {k: torch.from_numpy(v) for k, v in targets.items()}, draws=draws,
            loss_cfg=TL.MaskRCNNLossConfig(**LOSS_KW))
    out = {"losses": {k: float(v.detach()) for k, v in tl.items()}}
    if grad:
        tl["total"].backward()
        out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
        opt = TT.make_optimizer(model, 0.0025)
        TT.set_lr(opt, TT.warmup_multistep_lr(base_lr=0.0025)(0))
        opt.step()
        out.update(model=model, before=before)
    return out


@pytest.fixture(scope="module")
def steps():
    """The JAX package's losses in f32 and its f64 step; the port's f32
    losses with and without the mask head and its f64 step, on the JAX
    draws. The port's ResNet is narrowed here; the JAX package reads its
    widths from the weights."""
    from chip_smoke import synthetic_state_dict

    cfg = C4.MaskRCNNC4Config(**CFG_KW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C4, "ResNet", functools.partial(ResNet, width=WIDTH))
        sd = {k: v.numpy() for k, v in synthetic_state_dict(
            C4.build_model(cfg), 13).items()}
        images, targets = _inputs(np.random.default_rng(11))
        want32 = _jax_step(sd, images, targets, jnp.float32, grad=False)
        got32 = {mask_on: _torch_step(
            sd, C4.MaskRCNNC4Config(**CFG_KW, mask_on=mask_on), images,
            targets, want32["draws"], torch.float32, grad=False)["losses"]
            for mask_on in (True, False)}
        with jax.enable_x64(True):
            want64 = _jax_step(sd, images, targets, jnp.float64, grad=True)
        got64 = _torch_step(sd, cfg, images, targets, want64["draws"],
                            torch.float64, grad=True)
    return {"f32": (got32, want32["losses"]),
            "jax": want64, "port": got64}


def test_losses_match_jax_term_by_term(steps):
    """f32: rtol 1e-4; f64: rtol 1e-6 (the JAX package still casts the
    logits to f32, as in test_torch_maskrcnn_train). Faster R-CNN C4's four
    terms equal the Mask R-CNN model's, without loss_mask (both packages
    return before the mask head)."""
    got, want = steps["f32"]
    assert tuple(got[True]) == LOSS_KEYS and set(want) == set(LOSS_KEYS)
    assert set(got[False]) == set(LOSS_KEYS) - {"loss_mask"}
    for k in LOSS_KEYS:
        assert np.isfinite(got[True][k]) and got[True][k] > 0, k
        np.testing.assert_allclose(got[True][k], want[k], rtol=1e-4,
                                   err_msg=k)
        if k not in ("loss_mask", "total"):
            np.testing.assert_allclose(got[False][k], want[k], rtol=1e-4,
                                       err_msg=k)
    np.testing.assert_allclose(got[False]["total"],
                               want["total"] - want["loss_mask"], rtol=1e-4)
    g64, w64 = steps["port"]["losses"], steps["jax"]["losses"]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(g64[k], w64[k], rtol=1e-6, err_msg=k)


def test_gradients_and_sgd_step_match_jax(steps):
    """rtol 1e-3 / atol 1e-5 max|g| on every trainable parameter; res5
    under roi_heads trains, the stem and layer1 do not (the JAX package
    computes their gradients and its param groups leave them)."""
    port, jax_ = steps["port"], steps["jax"]
    model, grads = port["model"], port["grads"]
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert sorted(grads) == sorted(trainable)
    assert any(n.startswith("roi_heads.box.feature_extractor.head.layer4.")
               for n in trainable)
    assert not any(n.startswith(("backbone.body.stem.",
                                 "backbone.body.layer1.")) for n in trainable)
    after = model.state_dict()
    for name in trainable:
        assert_grad_close(grads[name].numpy(), jax_["grads"][name].numpy(),
                          name)
        assert_grad_close((after[name] - port["before"][name]).numpy(),
                          jax_["delta"][name].numpy(), name)
    for name in ("backbone.body.stem.conv1.weight",
                 "backbone.body.layer1.0.conv1.weight"):
        assert torch.equal(after[name], port["before"][name])


