"""YOLACT weights and entry points of tpuseg_torch: the state_dict keys
against tpuseg's ``to_torch_state``, upstream ``.pth`` loading, the
predictor's device default, its host post-processing against tpuseg's
engine, and the one-image CLI."""
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_yolact_state_dict
from tpuseg.configs import presets as JP
from tpuseg.engine import yolact_engine as JE
from tpuseg.models import yolact as JY
from tpuseg.weights.yolact_map import to_torch_state
from tpuseg_torch.configs.presets import yolact_model_config
from tpuseg_torch.engine.yolact_engine import YolactPredictor
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.weights.yolact_map import load_yolact_weights

# pytest-xdist runs several workers on the CPU's cores: more torch threads
# each would only oversubscribe them
torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["yolact_plus_resnet50", "yolact_plus_base"])
def test_state_dict_keys_are_to_torch_state_keys(name):
    """R-50++ (13 DCN blocks) and R-101++ (DCN every third block): the
    same keys, shapes and dtypes as the JAX package writes, and
    ``strict=True`` loads them."""
    jcfg = JP.yolact_model_config(getattr(JP, f"{name}_config"))
    flat = to_torch_state(jax.tree.map(np.asarray, JY.init_params(
        jax.random.PRNGKey(0), jcfg)), jcfg)
    model = Y.build_model(yolact_model_config(name))
    sd = model.state_dict()
    assert sd.keys() == flat.keys()
    for k, v in flat.items():
        assert tuple(sd[k].shape) == v.shape, k
        assert sd[k].dtype == torch.tensor(np.asarray(v)).dtype, k
    n_dcn = sum(k.endswith("conv_offset_mask.weight") for k in sd)
    assert n_dcn == (13 if name.endswith("resnet50") else 11)
    model.load_state_dict({k: torch.tensor(np.asarray(v))
                           for k, v in flat.items()}, strict=True)


def test_upstream_pth_loads(tmp_path):
    """A checkpoint as upstream saves it, with the keys upstream's
    load_weights drops: a torchvision backbone's ``backbone.layer1.*`` and a
    third FPN downsample layer."""
    cfg = dataclasses.replace(yolact_model_config("yolact_plus_resnet50"),
                              img_size=128)
    model = Y.build_model(cfg)
    sd = synthetic_yolact_state_dict(model, 1)
    extra = {"backbone.layer1.0.conv1.weight": torch.zeros(64, 64, 1, 1),
             "fpn.downsample_layers.2.weight": torch.zeros(256, 256, 3, 3)}
    path = tmp_path / "yolact_plus_resnet50_54_800000.pth"
    torch.save({**sd, **extra}, path)
    loaded = load_yolact_weights(str(path))
    assert loaded.keys() == sd.keys()
    pred = YolactPredictor(cfg, weights=str(path), device="cpu")
    for k, v in pred.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)


def test_predictor_defaults_to_the_card():
    default = inspect.signature(YolactPredictor.__init__).parameters["device"]
    assert default.default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            YolactPredictor(yolact_model_config("yolact_plus_resnet50"))


def test_postprocess_matches_jax_engine():
    """Masks upsampled with F.interpolate against the JAX engine's
    cv2.resize(INTER_LINEAR), binarised at 0.5; integer pixel boxes. The
    two resizes round differently (cv2 by up to 3e-6), so a pixel within 1e-5
    of 0.5 may fall on either side (3 of 2.5 M here); no other may."""
    rng = np.random.default_rng(3)
    k, s = 12, 138
    xy = rng.uniform(-0.1, 0.8, (k, 2))
    det = {"boxes": np.concatenate([xy, xy + rng.uniform(0.05, 0.5, (k, 2))],
                                   1).astype(np.float32),
           "scores": rng.uniform(0, 1, k).astype(np.float32),
           "classes": rng.integers(0, 80, k),
           "masks": rng.uniform(0, 1, (k, s, s)).astype(np.float32),
           "valid": np.arange(k) < 9,
           "mask_scores": rng.uniform(0, 1, k).astype(np.float32)}
    for h, w in ((480, 640), (100, 90)):  # up and down
        got = YolactPredictor.postprocess_image(None, det, h, w, 0.2)
        want = JE.YolactPredictor.postprocess_image(None, det, h, w, 0.2)
        assert got.keys() == want.keys()
        for key in ("boxes", "scores", "classes", "mask_scores"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["masks"].dtype == np.uint8 and got["masks"].any()
        kept = det["valid"] & (det["scores"] > 0.2)
        values = torch.nn.functional.interpolate(
            torch.from_numpy(det["masks"][kept])[:, None], size=(h, w),
            mode="bilinear", align_corners=False)[:, 0].numpy()
        flips = got["masks"] != want["masks"]
        assert flips.sum() <= 10
        assert (np.abs(values[flips] - 0.5) < 1e-5).all()


def test_predictor_batches_images_of_two_sizes():
    """predict_images: images grouped by size, ``batch_size`` at a time,
    each batch resized on the device; run_batch equals detect on the
    model's forward of the preprocessed batch."""
    cfg = dataclasses.replace(yolact_model_config("yolact_plus_resnet50"),
                              img_size=128)
    sd = synthetic_yolact_state_dict(Y.build_model(cfg), 2)
    pred = YolactPredictor(cfg, state_dict=sd, batch_size=2, device="cpu")
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in ((120, 160), (90, 70), (120, 160))]
    res = pred.predict_images(imgs)
    for img, r in zip(imgs, res):
        n = len(r["scores"])
        assert r["masks"].shape == (n,) + img.shape[:2]
        assert r["boxes"].shape == (n, 4) and r["mask_scores"].shape == (n,)
    det = pred.run_batch(np.stack([imgs[0], imgs[2]]))
    from tpuseg_torch.ops.preprocess import yolact_preprocess

    with torch.inference_mode():
        preds = pred.model(yolact_preprocess(
            torch.from_numpy(np.stack([imgs[0], imgs[2]])), 128))
        want = Y.detect(preds, pred.priors, cfg, pred.model.maskiou_net)
    for k, v in want.items():
        torch.testing.assert_close(det[k], v, rtol=0, atol=0, msg=k)
    again = pred.postprocess_image({k: v[1].numpy() for k, v in det.items()},
                                   120, 160)
    for k, v in again.items():
        np.testing.assert_array_equal(v, res[2][k], err_msg=k)


def test_cli_runs_one_image(tmp_path, capsys):
    import cv2

    from tpuseg_torch.tools import yolact_infer

    img = np.random.default_rng(6).integers(0, 256, (96, 128, 3),
                                            dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "in.png"), img)
    yolact_infer.main(["--config", "yolact_plus_resnet50", "--image",
                       str(tmp_path / "in.png"), "--device", "cpu",
                       "--score_threshold", "0", "--out",
                       str(tmp_path / "out.png")])
    assert "detections above 0.0" in capsys.readouterr().out
    assert cv2.imread(str(tmp_path / "out.png")).shape == img.shape
