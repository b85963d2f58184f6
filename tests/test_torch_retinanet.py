"""RetinaNet R-50-FPN of tpuseg_torch against tpuseg's retinanet: the
anchors, forward_inference detection for detection (full width, the
synthetic upstream checkpoint of test_cross_parity_retinanet), the
prior-prob init, and the training losses (f32) and gradients and SGD step
(f64) with padded-canvas anchors present (the second image is smaller than
the canvas), at a ResNet width of 16 and 32 FPN channels so that the JAX
package's f64 CPU convolutions run in seconds; 9 classes, 224x320 canvas."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cross_parity_retinanet import CANVAS, NC, _synth_state
from tests.test_torch_maskrcnn_train import (IMAGE_HW, LR, _inputs,
                                             assert_grad_close)
from tpuseg.engine import trainer as JT
from tpuseg.models import retinanet as JRN
from tpuseg_torch.engine import trainer as TT
from tpuseg_torch.engine.maskrcnn_engine import MaskRCNNPredictor
from tpuseg_torch.models import retinanet as RN
from tpuseg_torch.nn.resnet import ResNet
from tpuseg_torch.weights.from_jax import retinanet_state_dict_from_jax

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

CFG_KW = dict(num_classes=NC, pre_nms_top_n=200, detections_per_img=25)
WIDTH = 16  # the ResNet's stem width in the f64 gradient tests
NARROW = dict(fpn_channels=32)
LOSS_KEYS = ("loss_retina_cls", "loss_retina_reg", "total")


def _model(sd: dict, cfg) -> RN.RetinaNet:
    model = RN.build_model(cfg)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in sd.items()}, strict=True)
    return model


def _jax_params(sd: dict, jcfg, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype),
                        JRN.from_torch_state(sd, jcfg))


def _images(rng) -> np.ndarray:
    images = np.zeros((2, 3, *CANVAS), np.float32)
    for i, (h, w) in enumerate(IMAGE_HW):
        images[i, :, :h, :w] = rng.standard_normal((3, h, w)) * 40.0
    return images


@pytest.fixture(scope="module")
def inference():
    rng = np.random.default_rng(21)
    sd = _synth_state(rng)
    images = _images(rng)
    jcfg = JRN.RetinaNetConfig(**CFG_KW)
    want = jax.jit(lambda p, im, hw: JRN.forward_inference(p, im, hw, jcfg))(
        _jax_params(sd, jcfg), jnp.asarray(images.transpose(0, 2, 3, 1)),
        jnp.asarray(IMAGE_HW.astype(np.int32)))
    model = _model(sd, RN.RetinaNetConfig(**CFG_KW))
    with torch.inference_mode():
        got = RN.forward_inference(model, torch.from_numpy(images),
                                   torch.from_numpy(IMAGE_HW))
    return (model, images, {k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("canvas", [CANVAS, (800, 1344)])
def test_anchors_match_jax(canvas):
    got = RN.make_anchors_np(RN.RetinaNetConfig(), *canvas)
    want = JRN.make_anchors_np(JRN.RetinaNetConfig(), *canvas)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if canvas == (800, 1344):  # P7 at 800x1344: 7 x 11 cells
        assert got[-1].shape == (7 * 11 * 9, 4)


def test_forward_inference_matches_jax(inference):
    """Detection for detection at test_torch_maskrcnn's tolerances; the
    second image's detections stay inside it."""
    _, _, got, want = inference
    for k in ("boxes", "scores", "classes", "valid"):
        assert got[k].shape == want[k].shape, k
    for i in range(2):
        gv, wv = got["valid"][i], want["valid"][i]
        assert gv.sum() == wv.sum() > 0, f"image {i}: detection count"
        np.testing.assert_array_equal(got["classes"][i][gv],
                                      want["classes"][i][wv])
        np.testing.assert_allclose(got["scores"][i][gv], want["scores"][i][wv],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["boxes"][i][gv], want["boxes"][i][wv],
                                   rtol=1e-3, atol=0.05)
    b1 = got["boxes"][1][got["valid"][1]]
    assert (b1[:, 2] <= IMAGE_HW[1, 1] - 1).all()
    assert (b1[:, 3] <= IMAGE_HW[1, 0] - 1).all()
    # every level fills its top k (P6 and P7 hold fewer anchors than k)
    k = sum(min(CFG_KW["pre_nms_top_n"], a.shape[0])
            for a in RN.make_anchors_np(RN.RetinaNetConfig(), *CANVAS))
    assert got["candidate_valid"].sum(1).tolist() == [k, k] == [834, 834]


def test_predictor_runs_the_retinanet_variant(inference):
    model, images, got, _ = inference
    from tpuseg.engine import maskrcnn_engine as JE

    img = np.clip(images[0].transpose(1, 2, 0) + np.asarray(
        JE.DETECTRON_PIXEL_MEAN_BGR, np.float32), 0, 255).round().astype(
            np.uint8)
    pred = MaskRCNNPredictor(model=model, min_image_size=CANVAS[0],
                             max_image_size=CANVAS[1], device="cpu")
    assert pred.variant == "retinanet"
    res = pred.run_on_bgr_image(img)
    assert set(res) == {"boxes", "scores", "classes"}
    assert len(res["scores"]) > 0
    assert (np.diff(pred.select_top_predictions(res)["scores"]) <= 0).all()


def test_prior_prob_init_matches_jax():
    """The class logits' bias starts every sigmoid at prior_prob, as the
    JAX init_params' (tests/test_retinanet.py::test_prior_prob_bias_init)."""
    cfg = RN.RetinaNetConfig(num_classes=5)
    bias = RN.build_model(cfg, torch.Generator().manual_seed(0)) \
        .rpn.head.cls_logits.bias.detach()
    # jitted: only the bias is computed (eager, the whole init takes ~12 s)
    want = np.asarray(jax.jit(lambda k: JRN.init_params(
        k, JRN.RetinaNetConfig(num_classes=5))["cls_logits"]["bias"])(
            jax.random.PRNGKey(0)))
    assert bias.shape == want.shape == (9 * 4,)
    np.testing.assert_allclose(bias.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(torch.sigmoid(bias).numpy(), cfg.prior_prob,
                               rtol=1e-5)


def _jax_step(sd, images, targets, dtype, grad: bool) -> dict:
    jcfg = JRN.RetinaNetConfig(**CFG_KW)
    params = _jax_params(sd, jcfg, dtype)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def loss_fn(p):
        losses = JRN.forward_train_losses(
            p, jnp.asarray(images.transpose(0, 2, 3, 1), dtype),
            jnp.asarray(IMAGE_HW.astype(np.int32)), jt, jcfg)
        return losses["total"], losses

    if not grad:
        _, jl = jax.jit(loss_fn)(params)
        return {"losses": {k: float(v) for k, v in jl.items()}}
    ls, ws = JT.detectron_param_groups(params)

    def step(p):
        (_, losses), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        new, _ = JT.sgd_update(p, g, JT.sgd_init(p), LR, momentum=0.9,
                               weight_decay=1e-4, lr_scale=ls, wd_scale=ws)
        return losses, g, jax.tree.map(lambda a, b: a - b, new, p)

    jl, jg, delta = jax.jit(step)(params)
    return {"losses": {k: float(v) for k, v in jl.items()},
            "grads": retinanet_state_dict_from_jax(
                jax.tree.map(np.asarray, jg)),
            "delta": retinanet_state_dict_from_jax(
                jax.tree.map(np.asarray, delta))}


def _torch_step(sd, images, targets, dtype, grad: bool) -> dict:
    model = _model(sd, RN.RetinaNetConfig(**CFG_KW, **NARROW)).to(dtype)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.set_grad_enabled(grad):
        tl = RN.forward_train_losses(
            model, torch.from_numpy(images).to(dtype),
            torch.from_numpy(IMAGE_HW),
            {k: torch.from_numpy(v) for k, v in targets.items()})
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
    """Both packages' losses in f32 and their f64 step, on the narrow
    network with the smoke's upstream-keyed weights and upstream's
    prior-prob bias. The port's ResNet is narrowed here; the JAX package
    reads its widths from the weights."""
    from chip_smoke import synthetic_state_dict

    cfg = RN.RetinaNetConfig(**CFG_KW, **NARROW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RN, "ResNet", functools.partial(ResNet, width=WIDTH))
        sd = {k: v.numpy() for k, v in synthetic_state_dict(
            RN.build_model(cfg), 17).items()}
        sd["rpn.head.cls_logits.bias"][:] = RN.prior_bias(cfg)
        images, targets = _inputs(np.random.default_rng(19))
        targets = {k: targets[k] for k in ("boxes", "classes")}
        out = {"f32": (_torch_step(sd, images, targets, torch.float32, False),
                       _jax_step(sd, images, targets, jnp.float32, False))}
        with jax.enable_x64(True):
            out["jax"] = _jax_step(sd, images, targets, jnp.float64, True)
        out["port"] = _torch_step(sd, images, targets, torch.float64, True)
    return out


def test_losses_match_jax_term_by_term(steps):
    """f32 rtol 1e-4, f64 rtol 1e-6."""
    got, want = (s["losses"] for s in steps["f32"])
    assert tuple(got) == LOSS_KEYS and set(want) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        assert np.isfinite(got[k]) and got[k] > 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(steps["port"]["losses"][k],
                                   steps["jax"]["losses"][k], rtol=1e-6,
                                   err_msg=k)


def test_gradients_and_sgd_step_match_jax(steps):
    """rtol 1e-3 / atol 1e-5 max|g| on every trainable parameter; the stem
    and layer1 get no gradient in either package (FREEZE_CONV_BODY_AT 2)."""
    port, jax_ = steps["port"], steps["jax"]
    model, grads = port["model"], port["grads"]
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert sorted(grads) == sorted(trainable)
    assert not any(n.startswith(("backbone.body.stem.",
                                 "backbone.body.layer1.")) for n in trainable)
    after = model.state_dict()
    for name in trainable:
        assert_grad_close(grads[name].numpy(), jax_["grads"][name].numpy(),
                          name)
        assert_grad_close((after[name] - port["before"][name]).numpy(),
                          jax_["delta"][name].numpy(), name)
    for name, w in jax_["grads"].items():
        if name.startswith(("backbone.body.stem.", "backbone.body.layer1.")):
            assert not np.abs(w.numpy()).any(), name
