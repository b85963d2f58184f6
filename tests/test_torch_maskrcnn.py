"""The whole Mask R-CNN R-50-FPN inference slice of tpuseg_torch against
tpuseg's forward_inference, on the synthetic upstream checkpoint of
test_cross_parity (full width, 9 classes, 224x320 canvas)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cross_parity import CANVAS, NC, _synth_state
from tpuseg.engine import maskrcnn_engine as JE
from tpuseg.models import maskrcnn as JM
from tpuseg.weights.detectron_map import from_torch_state
from tpuseg_torch.engine.maskrcnn_engine import MaskRCNNPredictor
from tpuseg_torch.models import maskrcnn as M

CFG_KW = dict(num_classes=NC, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=200,
              fpn_post_nms_top_n=100, detections_per_img=20,
              pre_final_nms_topk=512)
# image 1 is smaller than the canvas: anchor_inside_mask and the per-image
# clip decide what it sees
IMAGE_HW = np.array([CANVAS, (176, 256)], np.int64)


@pytest.fixture(scope="module")
def slice_setup():
    rng = np.random.default_rng(42)
    sd = _synth_state(rng)
    model = M.build_model(M.MaskRCNNConfig(**CFG_KW))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    images = np.zeros((2, 3, *CANVAS), np.float32)
    for i, (h, w) in enumerate(IMAGE_HW):
        images[i, :, :h, :w] = rng.standard_normal((3, h, w)) * 40.0
    with torch.inference_mode():
        got = M.forward_inference(model, torch.from_numpy(images),
                                  torch.from_numpy(IMAGE_HW))
    got = {k: v.numpy() for k, v in got.items()}
    jcfg = JM.MaskRCNNConfig(**CFG_KW)
    params = jax.tree.map(jnp.asarray, from_torch_state(sd, jcfg))
    want = jax.jit(lambda p, im, hw: JM.forward_inference(p, im, hw, jcfg))(
        params, jnp.asarray(images.transpose(0, 2, 3, 1)),
        jnp.asarray(IMAGE_HW.astype(np.int32)))
    want = {k: np.asarray(v) for k, v in want.items()}
    return model, images, got, want


def test_forward_inference_matches_jax(slice_setup):
    _, _, got, want = slice_setup
    for k in ("boxes", "scores", "classes", "valid", "masks"):
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
        np.testing.assert_allclose(got["masks"][i][gv], want["masks"][i][wv],
                                   rtol=1e-3, atol=2e-3)
    # the smaller image's detections stay inside it
    b1 = got["boxes"][1][got["valid"][1]]
    assert (b1[:, 2] <= IMAGE_HW[1, 1] - 1).all()
    assert (b1[:, 3] <= IMAGE_HW[1, 0] - 1).all()


def test_predictor_pasted_masks_match_jax_paste(slice_setup):
    model, images, got, _ = slice_setup
    h, w = IMAGE_HW[0]
    # a BGR image that is exactly the canvas at min/max size 224/320, so the
    # resize is the identity; its forward is image 0's
    img = np.clip(images[0].transpose(1, 2, 0) + np.asarray(
        JE.DETECTRON_PIXEL_MEAN_BGR, np.float32), 0, 255).round().astype(np.uint8)
    pred = MaskRCNNPredictor(model=model, min_image_size=CANVAS[0],
                             max_image_size=CANVAS[1], device="cpu")
    res = pred.run_on_bgr_image(img)
    n = len(res["scores"])
    assert n > 0 and res["masks"].shape == (n, h, w)
    assert res["masks"].dtype == np.uint8
    canvas, _, _ = JE.preprocess_image_bgr(img, CANVAS[0], CANVAS[1])
    with torch.inference_mode():
        raw = M.forward_inference(
            model, torch.from_numpy(canvas.transpose(2, 0, 1)[None].copy()),
            torch.tensor([[h, w]]))
    valid = raw["valid"][0].numpy()
    masks28 = raw["masks"][0].numpy()[valid]
    np.testing.assert_array_equal(res["scores"], raw["scores"][0].numpy()[valid])
    want = JE.paste_masks(masks28, res["boxes"], h, w)
    # cv2 and torch round the bilinear weights differently, which can flip
    # a pixel whose value lies at the 0.5 threshold
    diff = (res["masks"] != want).mean()
    assert diff <= 1e-3, diff
    assert want.any()
    top = pred.select_top_predictions(res)
    assert (top["scores"] >= pred.confidence_threshold).all()
    assert (np.diff(top["scores"]) <= 0).all()
