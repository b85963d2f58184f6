"""The YOLACT++ R-50-FPN inference slice of tpuseg_torch against tpuseg's
YOLACT: priors, SSD decode, Fast-NMS, crop, preprocessing, the FPN's
upsampling, and the whole forward + detect at full width (R-50 with 13
DCNv2 blocks, 256 FPN channels, 81 classes, 32 prototypes) on a 256x256
canvas, B = 2, with upstream-keyed weights from a numpy seed carried across
by ``yolact_state_dict_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import calibrate_yolact_gate, synthetic_yolact_state_dict
from tpuseg.configs import presets as JP
from tpuseg.core import boxes as jbox
from tpuseg.models import yolact as JY
from tpuseg.ops import nms as jnms
from tpuseg.ops.preprocess import yolact_preprocess as j_preprocess
from tpuseg.weights.yolact_map import from_torch_state
from tpuseg_torch.configs.presets import yolact_model_config
from tpuseg_torch.core import boxes as box_ops
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.ops import nms as nms_ops
from tpuseg_torch.ops.preprocess import yolact_preprocess
from tpuseg_torch.weights.from_jax import yolact_state_dict_from_jax

# pytest-xdist runs several workers on the CPU's cores: more torch threads
# each would only oversubscribe them
torch.set_num_threads(2)

CANVAS = 256
IMAGES_HW = (300, 260)  # a non-square input, resized to the canvas


def _jcfg(cfg: Y.YolactConfig) -> JY.YolactConfig:
    return JY.YolactConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(cfg)})


@pytest.mark.parametrize("name", ["yolact_base", "yolact_im400",
                                  "yolact_plus_base", "yolact_plus_resnet50",
                                  "yolact_darknet53"])
def test_presets_and_priors_match_jax(name):
    cfg = yolact_model_config(name)
    jcfg = JP.yolact_model_config(getattr(JP, f"{name}_config"))
    assert _jcfg(cfg) == dataclasses.replace(jcfg, approx_topk=False)
    assert Y.level_sizes(cfg) == JY.level_sizes(jcfg)
    np.testing.assert_array_equal(Y.make_priors_np(cfg),
                                  JY.make_priors_np(jcfg))


def test_ssd_decode_and_crop_match_jax(rng):
    loc = rng.standard_normal((2, 500, 4)).astype(np.float32)
    pri = np.concatenate([rng.uniform(0, 1, (500, 2)),
                          rng.uniform(0.01, 0.6, (500, 2))], 1).astype(
                              np.float32)
    got = box_ops.ssd_decode(torch.from_numpy(loc), torch.from_numpy(pri))
    want = jbox.ssd_decode(jnp.asarray(loc), jnp.asarray(pri))
    # the two libraries' f32 exp differ in the last bit: an ulp of the
    # extent, 1e-7 of the unit canvas after the centre's subtraction
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.5e-7,
                               atol=1e-7)
    np.testing.assert_array_equal(
        box_ops.cxcywh_to_xyxy(torch.from_numpy(pri)).numpy(),
        np.asarray(jbox.cxcywh_to_xyxy(jnp.asarray(pri))))
    # boxes past the border and with swapped corners
    masks = rng.uniform(size=(2, 32, 32, 7)).astype(np.float32)
    boxes = rng.uniform(-0.2, 1.2, (2, 7, 4)).astype(np.float32)
    got = Y.crop_masks(torch.from_numpy(masks), torch.from_numpy(boxes))
    for i in range(2):
        want = JY._crop_masks(jnp.asarray(masks[i]), jnp.asarray(boxes[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_fast_nms_matches_jax_with_ties(rng):
    n, c = 300, 6
    xy = rng.uniform(0, 0.8, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.02, 0.3, (n, 2))],
                           1).astype(np.float32)
    boxes[40:60] = boxes[39]  # duplicates
    # scores on a coarse grid: many ties, which fall to the lower index
    scores = (rng.uniform(size=(c, n)) * 8).round().astype(np.float32) / 8
    got = nms_ops.fast_nms(torch.from_numpy(boxes)[None],
                           torch.from_numpy(scores)[None], 0.5, 200)
    want = jnms.fast_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 200)
    for g, w, name in zip(got, want, ("boxes", "scores", "classes", "idx",
                                      "keep")):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w),
                                      err_msg=name)


def test_batched_nms_mask_matches_jax_per_image(rng):
    n = 400
    xy = rng.uniform(0, 0.8, (2, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.02, 0.3, (2, n, 2))],
                           -1).astype(np.float32)
    boxes[1] *= 3.0  # another coordinate range: another offset
    scores = rng.uniform(size=(2, n)).astype(np.float32)
    cls = rng.integers(0, 5, (2, n))
    valid = rng.uniform(size=(2, n)) < 0.9
    got = nms_ops.batched_nms_mask(
        *map(torch.from_numpy, (boxes, scores, cls)), 0.5,
        valid=torch.from_numpy(valid))
    for i in range(2):
        want = jnms.batched_nms_mask(jnp.asarray(boxes[i]),
                                     jnp.asarray(scores[i]),
                                     jnp.asarray(cls[i]), 0.5,
                                     valid=jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        one = nms_ops.batched_nms_mask(
            *(torch.from_numpy(a[i]) for a in (boxes, scores, cls)), 0.5,
            valid=torch.from_numpy(valid[i]))
        np.testing.assert_array_equal(one.numpy(), np.asarray(want))


@pytest.mark.parametrize("hw", [(550, 550), (480, 640), (300, 260)])
def test_yolact_preprocess_matches_jax(rng, hw):
    imgs = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    got = yolact_preprocess(torch.from_numpy(imgs), 550)
    want = np.asarray(j_preprocess(jnp.asarray(imgs), size=550))
    assert got.shape == (2, 3, 550, 550)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [(35, 69), (18, 35), (9, 18), (69, 138)])
def test_fpn_upsample_matches_jax_resize(rng, src, dst):
    """The FPN's top-down and ProtoNet's x2 upsampling: F.interpolate
    (half-pixel, align_corners=False) equals jax.image.resize(linear,
    antialias=False), odd sizes and borders included, to the rounding of
    jax's normalised scale-and-translate weights (a few ulps of |x| <= 5)."""
    x = rng.standard_normal((2, 5, src, src)).astype(np.float32)
    got = F.interpolate(torch.from_numpy(x), size=(dst, dst), mode="bilinear",
                        align_corners=False)
    want = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)),
                            (2, dst, dst, 5), "linear", antialias=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Slice:
    cfg: Y.YolactConfig
    jcfg: JY.YolactConfig
    port: Y.Yolact
    params: dict
    preds: dict
    jpreds: dict
    priors: torch.Tensor
    jpriors: jax.Array


@pytest.fixture(scope="module")
def slice_setup():
    cfg = dataclasses.replace(yolact_model_config("yolact_plus_resnet50"),
                              img_size=CANVAS)
    jcfg = _jcfg(cfg)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (2, *IMAGES_HW, 3), dtype=np.uint8)
    x = yolact_preprocess(torch.from_numpy(imgs), CANVAS)
    model = Y.build_model(cfg)
    model.load_state_dict(synthetic_yolact_state_dict(model, 5), strict=True)
    calibrate_yolact_gate(model, x)  # a few dozen priors pass, none near
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = jax.tree.map(
        lambda a: None if a is None else jnp.asarray(a),
        from_torch_state(sd, jcfg),
        is_leaf=lambda a: a is None or isinstance(a, np.ndarray))
    # the weights go back through yolact_state_dict_from_jax
    sd_back = yolact_state_dict_from_jax(
        jax.tree.map(lambda a: None if a is None else np.asarray(a), params,
                     is_leaf=lambda a: a is None), cfg)
    assert sd_back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(sd_back[k].numpy(), v, err_msg=k)
    port = Y.build_model(cfg)
    port.load_state_dict(sd_back, strict=True)
    with torch.inference_mode():
        preds = port(yolact_preprocess(torch.from_numpy(imgs), CANVAS))
    priors = torch.from_numpy(Y.make_priors_np(cfg))
    jpriors = jnp.asarray(JY.make_priors_np(jcfg))

    def jrun(p, im):
        return JY.forward(p, j_preprocess(im, size=CANVAS), jcfg)

    jpreds = jax.jit(jrun)(params, jnp.asarray(imgs))
    jpreds = {k: np.array(v) for k, v in jpreds.items()}
    return Slice(cfg, jcfg, port, params, preds, jpreds, priors,
                       jpriors)


def test_forward_matches_jax(slice_setup):
    s = slice_setup
    for k in ("loc", "conf", "coeff", "proto"):
        got, want = s.preds[k].numpy(), s.jpreds[k]
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def _assert_same_detections(got: dict, want: dict, maskiou: bool) -> None:
    for i in range(got["valid"].shape[0]):
        gv, wv = got["valid"][i].numpy(), np.asarray(want["valid"][i])
        assert gv.sum() == wv.sum() > 0, f"image {i}: detection count"
        np.testing.assert_array_equal(got["classes"][i][gv].numpy(),
                                      np.asarray(want["classes"][i])[wv])
        np.testing.assert_allclose(got["boxes"][i][gv].numpy(),
                                   np.asarray(want["boxes"][i])[wv],
                                   rtol=0, atol=1e-4)
        keys = ("scores", "mask_scores") if maskiou else ("scores",)
        for k in keys:
            np.testing.assert_allclose(got[k][i][gv].numpy(),
                                       np.asarray(want[k][i])[wv],
                                       rtol=1e-4, atol=0, err_msg=k)
        np.testing.assert_allclose(got["masks"][i][gv].numpy(),
                                   np.asarray(want["masks"][i])[wv],
                                   rtol=0, atol=1e-3)


def test_forward_and_detect_match_jax(slice_setup):
    """Each through its own forward: detection for detection."""
    s = slice_setup
    with torch.inference_mode():
        got = Y.detect(s.preds, s.priors, s.cfg, s.port.maskiou_net)
    want = jax.jit(lambda p, pr: JY.detect(p, pr, s.jcfg,
                                           params_miou=s.params["maskiou"]))(
        {k: jnp.asarray(v) for k, v in s.jpreds.items()}, s.jpriors)
    assert "mask_scores" in got
    _assert_same_detections(got, want, maskiou=True)


@pytest.mark.parametrize("variant", [{"prior_topk": 64},
                                     {"use_fast_nms": False},
                                     {"use_fast_nms": False,
                                      "prior_topk": 64}])
def test_detect_variants_match_jax(slice_setup, variant):
    """The two-stage prior gate and the greedy-NMS branch, both sides on
    the same (JAX) predictions."""
    s = slice_setup
    cfg = dataclasses.replace(s.cfg, **variant)
    jcfg = _jcfg(cfg)
    with torch.inference_mode():
        got = Y.detect({k: torch.from_numpy(v) for k, v in s.jpreds.items()},
                       s.priors, cfg)
    want = jax.jit(lambda p, pr: JY.detect(p, pr, jcfg))(
        {k: jnp.asarray(v) for k, v in s.jpreds.items()}, s.jpriors)
    _assert_same_detections(got, want, maskiou=False)
