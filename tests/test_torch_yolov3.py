"""tpuseg_torch's YOLOv3 (DarkNet-53) inference against tpuseg's, on the
CPU, at full width (80 classes) on small inputs (64 and 160 px, B = 2):
both packages read one synthetic darknet ``.weights`` file with their own
readers; the raw head maps, ``decode``, the letterbox (ragged sizes and a
padded (1, 1) slot), ``unletterbox_boxes`` and the predictors' detections,
detection for detection at tests/test_cross_parity_yolov3.py's
tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cross_parity_yolov3 import write_synth_weights
from tpuseg.engine import yolo_engine as JE
from tpuseg.models import yolov3 as JY
from tpuseg.ops.preprocess import letterbox_preprocess as j_letterbox
from tpuseg.weights.darknet_io import load_yolov3_weights as j_load
from tpuseg_torch.core import boxes as box_ops
from tpuseg_torch.engine import yolo_engine as TE
from tpuseg_torch.models import yolov3 as TY
from tpuseg_torch.ops.preprocess import letterbox_preprocess
from tpuseg_torch.weights.darknet_io import load_yolov3_weights
from tpuseg_torch.weights.from_jax import yolov3_state_dict_from_jax

torch.set_num_threads(2)

# (h, w) of the images of a batch on a 100 x 90 canvas
HW = ((100, 90), (61, 80))


def jax_params(path: str, cfg) -> dict:
    """tpuseg's reader into a zero tree of the model's shapes (no
    ``init_params``: its random draws take ~12 s here)."""
    shapes = jax.eval_shape(lambda: JY.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    like = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return jax.tree.map(jnp.asarray, j_load(path, like))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The .weights file, tpuseg's params and the port's state_dict read
    from it (the params do not depend on the input size)."""
    path = str(tmp_path_factory.mktemp("yolo") / "synth.weights")
    write_synth_weights(path, np.random.default_rng(33))
    model = load_yolov3_weights(path, TY.build_model(TY.YoloV3Config()))
    return path, jax_params(path, JY.YoloV3Config()), model.state_dict()


def configs(size: int) -> tuple:
    """tests/test_cross_parity_yolov3.py's: NMS keeps 181 and 177 of 252
    candidates at 64 px, 526 and 527 of the top 1000 at 160, and the top
    50 of those are compared (further down the scores crowd within
    rounding of each other, and the two frameworks may order them
    differently)."""
    kw = dict(input_size=size, conf_thresh=0.05, max_det=50)
    return TY.YoloV3Config(**kw), JY.YoloV3Config(**kw)


def canvas(rng, hws=HW) -> tuple:
    h = max(a for a, _ in hws)
    w = max(b for _, b in hws)
    imgs = np.zeros((len(hws), h, w, 3), np.uint8)
    for i, (a, b) in enumerate(hws):
        imgs[i, :a, :b] = rng.integers(0, 256, (a, b, 3))
    return imgs, np.asarray(hws, np.int32)


def test_darknet_reader_matches_tpuseg(weights):
    """The port's reader fills the model with tpuseg's reader's arrays,
    in cfg order, every float of the file used."""
    _, jp, got = weights
    want = yolov3_state_dict_from_jax(jax.tree.map(np.asarray, jp))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("size", [64, 160])
def test_head_maps_and_decode_match_tpuseg(weights, size):
    """Raw head maps within rtol 1e-4 / atol 1e-4 max|ref|; decode of the
    same maps within 1e-5 (of max|ref| for the boxes)."""
    tcfg, jcfg = configs(size)
    _, jp, sd = weights
    rng = np.random.default_rng(size)
    x = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: JY.forward(p, x, jcfg))(jp, jnp.asarray(x))
    model = TY.build_model(tcfg)
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    jdec = jax.jit(lambda o: JY.decode(o, jcfg))(want)
    tdec = TY.decode([torch.from_numpy(np.array(w)) for w in want], tcfg)
    for g, w in zip(tdec, jdec):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_letterbox_and_unletterbox_match_tpuseg():
    """Ragged images on one canvas, an upscale and a downscale, and a
    padded slot with hw = (1, 1): within 1e-5."""
    rng = np.random.default_rng(1)
    imgs, hw = canvas(rng, ((100, 90), (61, 80), (1, 1)))
    for size in (64, 160):
        want = np.asarray(j_letterbox(jnp.asarray(imgs), jnp.asarray(hw),
                                      size=size)).transpose(0, 3, 1, 2)
        got = letterbox_preprocess(torch.from_numpy(imgs),
                                   torch.from_numpy(hw), size=size)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    boxes = rng.uniform(-20, 180, (30, 4)).astype(np.float32)
    for h, w in ((100, 90), (61, 80), (1, 1)):
        np.testing.assert_allclose(
            TE.unletterbox_boxes(boxes, h, w, 160),
            JE.unletterbox_boxes(boxes, h, w, 160), rtol=1e-5, atol=1e-5)


def assert_same_detections(got: dict, want: dict) -> int:
    """Image by image: equal counts and classes, scores rtol 2e-4 / atol
    1e-5, boxes rtol 1e-3 / atol 0.05 -> the detections compared."""
    total = 0
    for i in range(len(want["valid"])):
        wv, gv = np.asarray(want["valid"][i]), got["valid"][i]
        assert gv.sum() == wv.sum(), (i, gv.sum(), wv.sum())
        np.testing.assert_array_equal(got["classes"][i][gv],
                                      np.asarray(want["classes"][i])[wv])
        np.testing.assert_allclose(got["scores"][i][gv],
                                   np.asarray(want["scores"][i])[wv],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["boxes"][i][gv],
                                   np.asarray(want["boxes"][i])[wv],
                                   rtol=1e-3, atol=0.05)
        total += int(wv.sum())
    return total


@pytest.mark.parametrize("size", [64, 160])
def test_predictor_detections_match_tpuseg(weights, size):
    """YoloPredictor.run_batch (uint8 canvas -> letterbox -> DarkNet-53 ->
    decode -> top-k -> class-aware NMS -> top max_det) against tpuseg's,
    B = 2, the images ragged on the canvas: detection for detection."""
    tcfg, jcfg = configs(size)
    imgs, hw = canvas(np.random.default_rng(7))
    path, jp, sd = weights
    jpred = JE.YoloPredictor(jcfg, params=jp, batch_size=2)
    tpred = TE.YoloPredictor(tcfg, weights=path if size == 64 else None,
                             state_dict=sd, batch_size=2, device="cpu")
    want = jpred.run_batch(imgs, hw)
    got = tpred.run_batch(imgs, hw)
    assert got["boxes"].shape == (2, tcfg.max_det, 4)
    assert assert_same_detections(got, want) == 2 * tcfg.max_det
    for i in range(2):  # no two kept boxes of a class overlap above 0.45
        b = torch.from_numpy(got["boxes"][i])
        c = torch.from_numpy(got["classes"][i])
        iou = box_ops.iou_matrix(b, b).triu(1)
        assert not ((iou > tcfg.nms_thresh) & (c[:, None] == c)).any()
