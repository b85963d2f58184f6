"""The Mask R-CNN training step of tpuseg_torch against tpuseg's
forward_train_losses, jax.grad and sgd_update, on the synthetic upstream
checkpoint of test_cross_parity (full R-50-FPN width, 9 classes, 224x320
canvas, small sampling budgets) and the JAX package's own uniform draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cross_parity import CANVAS, NC, _synth_state
from tests.test_torch_maskrcnn_loss import jax_draws_per_image
from tpuseg.engine import trainer as JT
from tpuseg.models import maskrcnn as JM
from tpuseg.models import maskrcnn_loss as JL
from tpuseg.weights.detectron_map import from_torch_state
from tpuseg_torch.engine import trainer as TT
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import maskrcnn_loss as TL
from tpuseg_torch.nn.layers import FrozenBatchNorm2d
from tpuseg_torch.weights.from_jax import state_dict_from_jax

# pytest-xdist runs several workers on the CPU's cores: more torch threads
# each would only oversubscribe them
torch.set_num_threads(2)

CFG_KW = dict(num_classes=NC, rpn_pre_nms_top_n_train=300,
              fpn_post_nms_top_n_train=200)
LOSS_KW = dict(num_classes=NC, rpn_batch_per_image=64, roi_batch_per_image=64)
IMAGE_HW = np.array([CANVAS, (176, 256)], np.int64)
G = 8
LOSS_KEYS = ("loss_rpn_box_reg", "loss_objectness", "loss_classifier",
             "loss_box_reg", "loss_mask", "total")
LR = JT.warmup_multistep_lr(base_lr=0.0025)(0)


def _inputs(rng):
    b = len(IMAGE_HW)
    images = np.zeros((b, 3, *CANVAS), np.float32)
    boxes = np.zeros((b, G, 4), np.float32)
    for i, (h, w) in enumerate(IMAGE_HW):
        images[i, :, :h, :w] = rng.standard_normal((3, h, w)) * 40.0
        xy = rng.uniform(0, [w * 0.6, h * 0.6], (G, 2))
        wh = rng.uniform(16, [w * 0.4, h * 0.4], (G, 2))
        boxes[i] = np.concatenate([xy, xy + wh], -1)
    classes = rng.integers(0, NC - 1, (b, G)).astype(np.int32)
    classes[0, 6:] = -1
    classes[1, 5:] = -1
    yy, xx = np.mgrid[:32, :32] / 32
    crops = np.stack([np.stack([np.sin(5 * xx + i + 2 * j) * np.cos(4 * yy - j)
                                > -0.3 for j in range(G)]) for i in range(b)])
    return images, {"boxes": boxes, "classes": classes,
                    "mask_crops": crops.astype(np.float32)}


def _jax_step(sd, images, targets, dtype, grad: bool) -> dict:
    """The JAX package's step in ``dtype`` (call under jax.enable_x64 for
    float64): losses, the samplers' draws from its key tree and, with
    ``grad``, the gradients and the SGD update (detectron param groups),
    both as upstream-keyed state dicts."""
    key = jax.random.PRNGKey(5)
    jcfg = JM.MaskRCNNConfig(**CFG_KW)
    lcfg = JL.MaskRCNNLossConfig(**LOSS_KW)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                          from_torch_state(sd, jcfg))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def loss_fn(p):
        losses = JM.forward_train_losses(
            p, jnp.asarray(images.transpose(0, 2, 3, 1), dtype),
            jnp.asarray(IMAGE_HW.astype(np.int32)), jt, key, jcfg, lcfg)
        return losses["total"], losses

    cfg = M.MaskRCNNConfig(**CFG_KW)
    k_rpn, k_roi = jax.random.split(key)
    n_anchors = sum(a.shape[0] for a in M.make_anchors_np(cfg, *CANVAS))
    out = {"draws": {"rpn": jax_draws_per_image(k_rpn, 2, n_anchors),
                     "roi": jax_draws_per_image(
                         k_roi, 2, cfg.fpn_post_nms_top_n_train + G)}}
    if not grad:
        _, jl = jax.jit(loss_fn)(params)
        out["losses"] = {k: float(v) for k, v in jl.items()}
        return out
    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    ls, ws = JT.detectron_param_groups(params)
    jnew, _ = JT.sgd_update(params, jg, JT.sgd_init(params), LR, momentum=0.9,
                            weight_decay=1e-4, lr_scale=ls, wd_scale=ws)
    delta = jax.tree.map(lambda a, b: np.asarray(a - b), jnew, params)
    out.update(losses={k: float(v) for k, v in jl.items()},
               grads=state_dict_from_jax(jax.tree.map(np.asarray, jg), cfg),
               delta=state_dict_from_jax(delta, cfg))
    return out


def _torch_step(sd, images, targets, draws, dtype, grad: bool) -> dict:
    """The port's step in ``dtype`` on the JAX package's draws."""
    model = M.build_model(M.MaskRCNNConfig(**CFG_KW))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    model = model.to(dtype)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.set_grad_enabled(grad):
        tl = M.forward_train_losses(
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


def _step(dtype: str, grad: bool) -> dict:
    rng = np.random.default_rng(11)
    sd = _synth_state(rng)
    images, targets = _inputs(rng)
    with jax.enable_x64(dtype == "float64"):
        want = _jax_step(sd, images, targets, getattr(jnp, dtype), grad)
    got = _torch_step(sd, images, targets, want["draws"],
                      getattr(torch, dtype), grad)
    return {"jax": want, "port": got}


@pytest.fixture(scope="module")
def step32():
    """The training forward in float32, the port's precision: losses."""
    return _step("float32", grad=False)


@pytest.fixture(scope="module")
def step64():
    """One training step in float64 on both sides: losses, gradients, and
    the parameters after SGD with the detectron param groups.

    Why float64 for the gradients: behind the ReLUs of the backbone and
    heads, a pre-activation within f32 rounding of 0 can land on either
    side in two frameworks whose f32 forwards agree to ~1e-7, and the
    gradient through that element moves. In float32
    (``_step("float32", grad=True)``) that moves single elements of the
    backbone's gradients by up to 7e-3 of max|g| (relative L2 error under
    2e-3). In float64 no pre-activation lies that close to 0, and what is
    left is the transposes, which the test holds to rtol 1e-3.
    """
    return _step("float64", grad=True)


# losses: f32 convolutions and sums in another order; in float64 the JAX
# package still pools and casts the logits in f32 (sampling.py,
# maskrcnn.py), so the losses agree to f32 rounding, not to f64's
@pytest.mark.parametrize("which,rtol", [("step32", 1e-4), ("step64", 1e-6)])
def test_losses_match_jax_term_by_term(request, which, rtol):
    step = request.getfixturevalue(which)
    got, want = step["port"]["losses"], step["jax"]["losses"]
    assert tuple(got) == LOSS_KEYS and set(want) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        assert np.isfinite(got[k]) and got[k] > 0, k
        # the same samples (same draws)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def assert_grad_close(got: np.ndarray, want: np.ndarray, name: str) -> None:
    """rtol 1e-3, atol 1e-5 max|g| elementwise."""
    scale = np.abs(want).max()
    if scale == 0:  # P5 and P6 get no gradient: no anchor there is sampled
        assert not np.abs(got).any(), name
        return
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * scale,
                               err_msg=name)


def test_gradients_match_jax_grad(step64):
    port, jax_ = step64["port"], step64["jax"]
    model, grads, want = port["model"], port["grads"], jax_["grads"]
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert sorted(grads) == sorted(trainable)
    assert not any(n.startswith(("backbone.body.stem.", "backbone.body.layer1."))
                   for n in trainable)
    for name in trainable:
        assert_grad_close(grads[name].numpy(), want[name].numpy(), name)
    # the JAX package stops the gradient after the frozen stages
    for name, w in want.items():
        if name.startswith(("backbone.body.stem.", "backbone.body.layer1.")):
            assert not np.abs(w.numpy()).any(), name


def test_sgd_step_matches_jax_sgd_update(step64):
    port, want = step64["port"], step64["jax"]["delta"]
    model, before = port["model"], port["before"]
    for name, p in model.named_parameters():
        if p.requires_grad:
            # the update lr * (g + wd p), held as its gradient is
            assert_grad_close((p.detach() - before[name]).numpy(),
                              want[name].numpy(), name)


def test_frozen_stages_and_frozen_bn_do_not_move(step64):
    model, before = step64["port"]["model"], step64["port"]["before"]
    sd = model.state_dict()
    frozen = [k for k in sd if k.startswith(("backbone.body.stem.",
                                             "backbone.body.layer1."))]
    for m_name, m in model.named_modules():
        if isinstance(m, FrozenBatchNorm2d):
            frozen += [f"{m_name}.{b}" for b, _ in m.named_buffers()]
    assert len(frozen) > 200
    for k in frozen:
        assert torch.equal(sd[k], before[k]), k
    moved = model.roi_heads.box.feature_extractor.fc6.weight.detach()
    assert not torch.equal(moved, before["roi_heads.box.feature_extractor."
                                         "fc6.weight"])


def test_per_batch_proposal_gate_matches_jax():
    """FPN_POST_NMS_PER_BATCH at the train budgets (top 2000 per level
    before NMS, top 2000 over the batch after it) on the 224x320 canvas."""
    rng = np.random.default_rng(4)
    cfg = M.MaskRCNNConfig(fpn_post_nms_per_batch=True)
    train = dict(rpn_pre_nms_top_n=2000, fpn_post_nms_top_n=2000,
                 fpn_post_nms_per_batch=True)
    jcfg = dataclasses.replace(JM.MaskRCNNConfig(), **train)
    tcfg = dataclasses.replace(cfg, **train)
    anchors = M.make_anchors_np(cfg, *CANVAS)
    logits = [rng.standard_normal((2, a.shape[0])).astype(np.float32)
              for a in anchors]
    deltas = [(rng.standard_normal((2, a.shape[0], 4)) * 0.1).astype(
        np.float32) for a in anchors]
    want = JM.rpn_proposals([jnp.asarray(x) for x in logits],
                            [jnp.asarray(x) for x in deltas],
                            [jnp.asarray(a) for a in anchors],
                            jnp.asarray(IMAGE_HW.astype(np.int32)), jcfg,
                            CANVAS)
    got = M.rpn_proposals([torch.from_numpy(x) for x in logits],
                          [torch.from_numpy(x) for x in deltas],
                          [torch.from_numpy(a) for a in anchors],
                          torch.from_numpy(IMAGE_HW), tcfg, CANVAS)
    wb, ws, wv = (np.asarray(x) for x in want)
    gb, gs, gv = (x.numpy() for x in got)
    np.testing.assert_array_equal(gv, wv)
    # the gate keeps 2000 over the batch, not 2000 per image
    assert gv.sum() == 2000 and gv.sum(1).min() > 0
    np.testing.assert_allclose(gs[gv], ws[wv], rtol=1e-6)
    np.testing.assert_allclose(gb[gv], wb[wv], rtol=1e-5, atol=1e-3)
