"""Faster R-CNN R-50-FPN (the FPN model with ``mask_on=False``) of
tpuseg_torch against tpuseg's: boxes-only forward_inference detection for
detection, and the training losses without loss_mask term by term in f32 on
the JAX package's draws; the synthetic upstream checkpoint of
test_cross_parity without its mask head (full width, 9 classes, 224x320
canvas)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_cross_parity import CANVAS, _synth_state
from tests.test_torch_maskrcnn import CFG_KW, IMAGE_HW
from tests.test_torch_maskrcnn_loss import jax_draws_per_image
from tests.test_torch_maskrcnn_train import CFG_KW as TRAIN_KW
from tests.test_torch_maskrcnn_train import LOSS_KW, _inputs
from tpuseg.models import maskrcnn as JM
from tpuseg.models import maskrcnn_loss as JL
from tpuseg.weights.detectron_map import from_torch_state
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import maskrcnn_loss as TL

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores


def _boxes_only(sd: dict, cfg) -> M.MaskRCNN:
    """The port's model without ``roi_heads.mask``: the boxes-only state
    loads strict."""
    model = M.build_model(cfg)
    assert not hasattr(model.roi_heads, "mask")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                           if not k.startswith("roi_heads.mask.")},
                          strict=True)
    return model


def test_boxes_only_inference_matches_jax():
    rng = np.random.default_rng(42)
    sd = _synth_state(rng)
    images = np.zeros((2, 3, *CANVAS), np.float32)
    for i, (h, w) in enumerate(IMAGE_HW):
        images[i, :, :h, :w] = rng.standard_normal((3, h, w)) * 40.0
    with torch.inference_mode():
        got = M.forward_inference(
            _boxes_only(sd, M.MaskRCNNConfig(**CFG_KW, mask_on=False)),
            torch.from_numpy(images), torch.from_numpy(IMAGE_HW))
    jcfg = JM.MaskRCNNConfig(**CFG_KW, mask_on=False)
    params = jax.tree.map(jnp.asarray, from_torch_state(sd, jcfg))
    assert "mask_head" not in params
    want = jax.jit(lambda p, im, hw: JM.forward_inference(p, im, hw, jcfg))(
        params, jnp.asarray(images.transpose(0, 2, 3, 1)),
        jnp.asarray(IMAGE_HW.astype(np.int32)))
    assert "masks" not in got and "masks" not in want
    for i in range(2):
        gv, wv = got["valid"][i].numpy(), np.asarray(want["valid"][i])
        assert gv.sum() == wv.sum() > 0, f"image {i}: detection count"
        np.testing.assert_array_equal(got["classes"][i].numpy()[gv],
                                      np.asarray(want["classes"][i])[wv])
        np.testing.assert_allclose(got["scores"][i].numpy()[gv],
                                   np.asarray(want["scores"][i])[wv],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["boxes"][i].numpy()[gv],
                                   np.asarray(want["boxes"][i])[wv],
                                   rtol=1e-3, atol=0.05)


def test_boxes_only_losses_match_jax_term_by_term():
    """Four losses and ``total``, no loss_mask, rtol 1e-4 in f32; the
    targets carry no mask crops."""
    rng = np.random.default_rng(11)
    sd = _synth_state(rng)
    images, targets = _inputs(rng)
    targets = {k: targets[k] for k in ("boxes", "classes")}
    key = jax.random.PRNGKey(5)
    jcfg = JM.MaskRCNNConfig(**TRAIN_KW, mask_on=False)
    want = jax.jit(lambda p: JM.forward_train_losses(
        p, jnp.asarray(images.transpose(0, 2, 3, 1)),
        jnp.asarray(IMAGE_HW.astype(np.int32)),
        {k: jnp.asarray(v) for k, v in targets.items()}, key, jcfg,
        JL.MaskRCNNLossConfig(**LOSS_KW)))(
            jax.tree.map(jnp.asarray, from_torch_state(sd, jcfg)))
    cfg = M.MaskRCNNConfig(**TRAIN_KW, mask_on=False)
    k_rpn, k_roi = jax.random.split(key)
    n_anchors = sum(a.shape[0] for a in M.make_anchors_np(cfg, *CANVAS))
    draws = {"rpn": jax_draws_per_image(k_rpn, 2, n_anchors),
             "roi": jax_draws_per_image(
                 k_roi, 2, cfg.fpn_post_nms_top_n_train
                 + targets["boxes"].shape[1])}
    with torch.no_grad():
        got = M.forward_train_losses(
            _boxes_only(sd, cfg), torch.from_numpy(images),
            torch.from_numpy(IMAGE_HW),
            {k: torch.from_numpy(v) for k, v in targets.items()},
            draws=draws, loss_cfg=TL.MaskRCNNLossConfig(**LOSS_KW))
    assert tuple(got) == ("loss_rpn_box_reg", "loss_objectness",
                          "loss_classifier", "loss_box_reg", "total")
    assert set(want) == set(got)
    for k, v in want.items():
        assert np.isfinite(float(got[k])) and float(got[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4,
                                   err_msg=k)
