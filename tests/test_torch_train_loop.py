"""The Mask R-CNN training loop of tpuseg_torch: its batch builder against
tpuseg's on a synthetic COCO dataset, its learning-rate schedule against
tpuseg's, and a two-step do_train on the CPU whose checkpoint loads back
strictly."""
import numpy as np
import pytest
import torch

from tests.test_cross_parity import NC
from tests.test_yolact_engine import _write_synth_dataset
from tpuseg.data.coco_dataset import CocoDetectionDataset
from tpuseg.engine import detectron_train_loop as JD
from tpuseg.engine.trainer import warmup_multistep_lr as j_warmup
from tpuseg_torch.engine import detectron_train_loop as TD
from tpuseg_torch.engine.trainer import warmup_multistep_lr
from tpuseg_torch.models import maskrcnn as M

# pytest-xdist runs several workers on the CPU's cores: more torch threads
# each would only oversubscribe them
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    img_dir, ann = _write_synth_dataset(str(tmp_path_factory.mktemp("coco")))
    return CocoDetectionDataset(img_dir, ann, label_map={1: 1, 2: 2})


@pytest.mark.parametrize("min_size,max_size", [(128, 128), (160, 256)])
def test_build_train_example_matches_jax(dataset, min_size, max_size):
    """No resize (128x128 images on a 128 canvas) and a PIL resize to 160;
    the same numpy generator decides the flips on both sides."""
    rng_j, rng_t = np.random.default_rng(1), np.random.default_rng(1)
    flips = 0
    for _ in range(3):
        for iid in dataset.image_ids:
            want = JD.build_train_example(dataset, iid, min_size, max_size,
                                          max_gt=8, crop=28, rng=rng_j)
            got = TD.build_train_example(dataset, iid, min_size, max_size,
                                         max_gt=8, crop=28, rng=rng_t)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
            for k in ("boxes", "classes"):
                np.testing.assert_array_equal(got[2][k], want[2][k], k)
            crops_t, crops_j = got[2]["mask_crops"], want[2]["mask_crops"]
            # cv2.warpAffine rounds source coordinates to 1/32 pixel and
            # its weights to fixed point, which moves values near the 0.5
            # threshold
            assert (crops_t != crops_j).mean() <= 0.01
            assert crops_t.sum() > 0
            flips += int(got[2]["boxes"][0, 0] != dataset.load_target(iid)[
                "boxes"][0, 0] * got[1][1] / 128)
    assert flips > 0  # the flip branch ran


def test_crop_mask_is_bilinear_with_zero_border():
    mask = np.zeros((6, 8), np.uint8)
    mask[1:4, 2:6] = 1
    out = TD.crop_mask(mask, np.array([2.0, 1.0, 6.0, 4.0]), 8)
    assert out.shape == (8, 8) and out.dtype == np.float32
    assert (out[2:6, 2:6] == 1).all()  # inside the box, the mask is full
    # a box reaching past the image: samples there read the zero border
    out = TD.crop_mask(np.ones((4, 4), np.uint8), np.array([2.0, 0.0, 6.0, 4.0]),
                       4)
    np.testing.assert_allclose(out[:, :2], 1.0)
    np.testing.assert_allclose(out[:, 3], 0.0)


def test_warmup_multistep_lr_matches_jax():
    for kw in ({}, {"base_lr": 0.0025, "steps": (30, 60), "warmup_iters": 20},
               {"warmup_method": "constant", "warmup_iters": 10}):
        jf, tf = j_warmup(**kw), warmup_multistep_lr(**kw)
        for it in (0, 1, 7, 10, 19, 20, 29, 30, 59, 60, 499, 500, 120000,
                   160000):
            # the JAX schedule computes in float32
            np.testing.assert_allclose(tf(it), float(jf(it)), rtol=1e-6,
                                       err_msg=f"{kw} it={it}")


def test_do_train_two_steps_on_cpu_writes_a_strict_checkpoint(dataset,
                                                               tmp_path,
                                                               capsys):
    cfg = M.MaskRCNNConfig(num_classes=NC, rpn_pre_nms_top_n_train=64,
                           fpn_post_nms_top_n_train=32)
    model, it, history = TD.do_train(
        dataset, cfg, max_steps=2, checkpoint_period=2, log_every=1,
        output_dir=str(tmp_path), device="cpu", min_size=128, max_size=128)
    assert it == 2 and len(history) == 2
    for losses in history:
        assert set(losses) == {"loss_rpn_box_reg", "loss_objectness",
                               "loss_classifier", "loss_box_reg",
                               "loss_mask", "total"}
        assert all(np.isfinite(v) for v in losses.values())
    out = capsys.readouterr().out
    assert "iter: 2" in out and "model_0000002.pth" in out
    ckpt = torch.load(tmp_path / "model_0000002.pth", weights_only=True)
    assert ckpt["iteration"] == 2
    fresh = M.build_model(cfg)
    fresh.load_state_dict(ckpt["model"], strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
