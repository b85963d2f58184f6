"""Mask R-CNN and Faster R-CNN R-50-C4 inference of tpuseg_torch against
tpuseg's maskrcnn_c4: the anchors, forward_inference with and without
masks and the predictor, on the synthetic upstream checkpoint of
test_cross_parity_c4 (full R-50 width, 9 classes, 224x320 canvas, small
budgets). The training step: test_torch_maskrcnn_c4_train.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cross_parity_c4 import CANVAS, NC, _synth_state
from tests.test_torch_maskrcnn_train import IMAGE_HW
from tpuseg.models import maskrcnn_c4 as JC4
from tpuseg_torch.engine.maskrcnn_engine import MaskRCNNPredictor
from tpuseg_torch.models import maskrcnn_c4 as C4

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

CFG_KW = dict(num_classes=NC, rpn_pre_nms_top_n=300, rpn_post_nms_top_n=100,
              detections_per_img=20, pre_final_nms_topk=512,
              rpn_pre_nms_top_n_train=300, rpn_post_nms_top_n_train=100)
MASK_KEYS = ("roi_heads.mask.",)


def _model(sd: dict, cfg) -> C4.MaskRCNNC4:
    model = C4.build_model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                           if cfg.mask_on or not k.startswith(MASK_KEYS)},
                          strict=True)
    return model


def _jax_params(sd: dict, jcfg, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype),
                        JC4.from_torch_state(sd, jcfg))


@pytest.fixture(scope="module")
def inference():
    """tpuseg's forward_inference (with masks) and the port's with and
    without the mask head, on one batch of two images (the second smaller
    than the canvas). The JAX package returns before its mask head when
    ``mask_on`` is False, so its boxes are the same either way."""
    rng = np.random.default_rng(7)
    sd = _synth_state(rng)
    images = np.zeros((2, 3, *CANVAS), np.float32)
    for i, (h, w) in enumerate(IMAGE_HW):
        images[i, :, :h, :w] = rng.standard_normal((3, h, w)) * 40.0
    jcfg = JC4.MaskRCNNC4Config(**CFG_KW)
    want = jax.jit(lambda p, im, hw: JC4.forward_inference(p, im, hw, jcfg))(
        _jax_params(sd, jcfg), jnp.asarray(images.transpose(0, 2, 3, 1)),
        jnp.asarray(IMAGE_HW.astype(np.int32)))
    want = {k: np.asarray(v) for k, v in want.items()}
    out = {}
    for mask_on in (True, False):
        cfg = C4.MaskRCNNC4Config(**CFG_KW, mask_on=mask_on)
        with torch.inference_mode():
            got = C4.forward_inference(_model(sd, cfg),
                                       torch.from_numpy(images),
                                       torch.from_numpy(IMAGE_HW))
        out[mask_on] = ({k: v.numpy() for k, v in got.items()}, want)
    return sd, images, out


def test_anchors_match_jax():
    for canvas in (CANVAS, (800, 1344)):
        cfg = C4.MaskRCNNC4Config()
        got = C4.make_anchors_np(cfg, *canvas)
        want = JC4.make_anchors_np(JC4.MaskRCNNC4Config(), *canvas)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (-(-canvas[0] // 16) * -(-canvas[1] // 16) * 15,
                             4)


@pytest.mark.parametrize("mask_on", [True, False])
def test_forward_inference_matches_jax(inference, mask_on):
    """Detection for detection at test_torch_maskrcnn's tolerances; the
    masks (14x14) too when the model has a mask head."""
    got, want = inference[2][mask_on]
    keys = ("boxes", "scores", "classes", "valid") + (
        ("masks",) if mask_on else ())
    assert ("masks" in got) == mask_on
    for k in keys:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got["proposal_valid"],
                                  want["proposal_valid"])
    for i in range(2):
        gv, wv = got["valid"][i], want["valid"][i]
        assert gv.sum() == wv.sum() > 0, f"image {i}: detection count"
        np.testing.assert_array_equal(got["classes"][i][gv],
                                      want["classes"][i][wv])
        np.testing.assert_allclose(got["scores"][i][gv], want["scores"][i][wv],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["boxes"][i][gv], want["boxes"][i][wv],
                                   rtol=1e-3, atol=0.05)
        if mask_on:
            np.testing.assert_allclose(got["masks"][i][gv],
                                       want["masks"][i][wv], rtol=1e-3,
                                       atol=2e-3)
    b1 = got["boxes"][1][got["valid"][1]]
    assert (b1[:, 2] <= IMAGE_HW[1, 1] - 1).all()
    assert (b1[:, 3] <= IMAGE_HW[1, 0] - 1).all()


def test_predictor_runs_the_c4_variant(inference):
    """MaskRCNNPredictor(variant="c4") on image 0 as a BGR image at the
    canvas size: its scores are the forward's, its masks pasted at the
    image's size; boxes only without the mask head."""
    sd, images, out = inference
    from tpuseg.engine import maskrcnn_engine as JE

    img = np.clip(images[0].transpose(1, 2, 0) + np.asarray(
        JE.DETECTRON_PIXEL_MEAN_BGR, np.float32), 0, 255).round().astype(
            np.uint8)
    for mask_on in (True, False):
        cfg = C4.MaskRCNNC4Config(**CFG_KW, mask_on=mask_on)
        pred = MaskRCNNPredictor(model=_model(sd, cfg),
                                 min_image_size=CANVAS[0],
                                 max_image_size=CANVAS[1], device="cpu")
        assert pred.variant == "c4"
        res = pred.run_on_bgr_image(img)
        n = len(res["scores"])
        assert n > 0 and ("masks" in res) == mask_on
        if mask_on:
            assert res["masks"].shape == (n, *CANVAS)
            assert res["masks"].dtype == np.uint8 and res["masks"].any()


def test_single_level_cfg_matches_jax():
    cfg = C4.MaskRCNNC4Config(**CFG_KW)
    for train in (False, True):
        got = C4._single_level_cfg(cfg, train)
        want = JC4._single_level_cfg(JC4.MaskRCNNC4Config(**CFG_KW), train)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
