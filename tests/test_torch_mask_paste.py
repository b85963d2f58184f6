"""YOLACT's mask paste (``tpuseg_torch/kernels/mask_paste.py``) and the
predictor's two paths: the plain paste against the host engine's, a slot
of CPU tensors against the same slot in numpy, and (marked ``cuda``) the
card's paste inside ``YolactPredictor`` against the host's. This file
imports no jax, so on a machine without jax it runs without the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_mask_paste.py
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from chip_smoke import synthetic_yolact_state_dict
from tpuseg_torch import kernels
from tpuseg_torch.configs.presets import yolact_model_config
from tpuseg_torch.engine.yolact_engine import YolactPredictor
from tpuseg_torch.kernels.mask_paste import paste_masks
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.utils import timer

# pytest-xdist runs several workers on the CPU's cores: more torch threads
# each would only oversubscribe them
torch.set_num_threads(2)

SIZES = [(480, 640), (100, 90), (550, 550), (1, 1)]


def _slot(k: int = 12, s: int = 138) -> dict:
    """``tests/test_torch_yolact_weights.py``'s slot: 12 detections, 9
    valid, some under the 0.2 score threshold."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(-0.1, 0.8, (k, 2))
    return {"boxes": np.concatenate([xy, xy + rng.uniform(0.05, 0.5, (k, 2))],
                                    1).astype(np.float32),
            "scores": rng.uniform(0, 1, k).astype(np.float32),
            "classes": rng.integers(0, 80, k),
            "masks": rng.uniform(0, 1, (k, s, s)).astype(np.float32),
            "valid": np.arange(k) < 9,
            "mask_scores": rng.uniform(0, 1, k).astype(np.float32)}


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("layout", ["contiguous", "detector"])
def test_plain_paste_equals_the_host_engine(hw, layout):
    """On the CPU paste_masks is the host engine's paste to the bit, also
    for masks in the detector's [K, S, S] view of an [S, S, K] array; no
    kernel launches."""
    h, w = hw
    det = _slot()
    want = YolactPredictor.postprocess_image(None, det, h, w, 0.2)["masks"]
    masks = torch.from_numpy(det["masks"])
    if layout == "detector":
        masks = masks.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    kept = np.flatnonzero(det["valid"] & (det["scores"] > 0.2))
    before = kernels.launch_counts()["mask_paste"]
    got = paste_masks(masks, kept, h, w)
    assert kernels.launch_counts()["mask_paste"] == before
    assert got.dtype == torch.uint8 and got.shape == (len(kept), h, w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_paste_of_no_masks():
    got = paste_masks(torch.zeros(5, 138, 138), np.zeros(0, np.int64), 48, 64)
    assert got.shape == (0, 48, 64) and got.dtype == torch.uint8


@pytest.mark.parametrize("index", [[0, 5], [-1], [[0, 1]]],
                         ids=["past_the_slots", "negative", "two_dims"])
def test_paste_rejects_an_index_outside_the_slots(index):
    with pytest.raises(ValueError):
        paste_masks(torch.zeros(5, 8, 8), np.asarray(index), 16, 16)


@pytest.mark.parametrize("hw", SIZES[:2], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_postprocess_of_cpu_tensors_equals_numpy(hw):
    """A slot of CPU torch tensors takes the host path: the same arrays as
    the slot in numpy, numpy out."""
    h, w = hw
    det = _slot()
    want = YolactPredictor.postprocess_image(None, det, h, w, 0.2)
    got = YolactPredictor.postprocess_image(
        None, {k: torch.from_numpy(np.asarray(v)) for k, v in det.items()},
        h, w, 0.2)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert isinstance(got[k], np.ndarray) and got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _ranges(prof) -> dict:
    """name -> count of the profiler's host ranges of the program's spans."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if ("CPU" in str(e.device_type())
                and e.name().startswith(timer.SPAN_PREFIX)):
            name = e.name()[len(timer.SPAN_PREFIX):]
            out[name] = out.get(name, 0) + 1
    return out


def _predictor(dev) -> YolactPredictor:
    cfg = dataclasses.replace(yolact_model_config("yolact_plus_resnet50"),
                              img_size=128)
    sd = synthetic_yolact_state_dict(Y.build_model(cfg), 2)
    return YolactPredictor(cfg, state_dict=sd, batch_size=2, device=dev)


def _images():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in ((120, 160), (90, 70), (120, 160))]


def test_host_predictor_pastes_nothing_on_the_card():
    """A CPU predictor hands numpy slots to the host paste: no launch, no
    ``predictor.masks_pasted_on_device``."""
    pred = _predictor("cpu")
    timer.reset()
    before = kernels.launch_counts()["mask_paste"]
    with profile(activities=[ProfilerActivity.CPU]):
        res = pred.predict_images(_images())
    c = timer.counters()
    assert c["predictor.masks"] == sum(len(r["scores"]) for r in res) > 0
    assert "predictor.masks_pasted_on_device" not in c
    assert kernels.launch_counts()["mask_paste"] == before
    timer.reset()


@pytest.mark.cuda
def test_card_paste_in_the_predictor_matches_the_host_paste():
    """One CUDA predictor: a slot whose masks stay on the card against its
    numpy download (boxes, scores, classes, mask_scores equal; a mask pixel
    may differ only where its value lies within 1e-5 of 0.5), and
    predict_images' counters: every mask pasted on the card, one launch an
    image with masks, the small tensors and the uint8 masks downloaded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    pred = _predictor(dev)
    imgs = _images()
    h, w = imgs[1].shape[:2]
    det = pred.run_batch(imgs[1][None])
    on_card = {k: v[0] if k == "masks" else v[0].cpu().numpy()
               for k, v in det.items()}
    on_host = {k: v[0].cpu().numpy() for k, v in det.items()}
    got = pred.postprocess_image(on_card, h, w)
    want = pred.postprocess_image(on_host, h, w)
    assert got.keys() == want.keys() and len(want["scores"]) > 0
    for k in ("boxes", "scores", "classes", "mask_scores"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["masks"].dtype == np.uint8
    kept = on_host["valid"] & (on_host["scores"] > 0)
    values = F.interpolate(torch.from_numpy(on_host["masks"][kept])[:, None],
                           size=(h, w), mode="bilinear",
                           align_corners=False)[:, 0].numpy()
    flips = got["masks"] != want["masks"]
    assert (np.abs(values[flips] - 0.5) < 1e-5).all()

    timer.reset()
    before = kernels.launch_counts()["mask_paste"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = pred.predict_images(imgs)
    c = timer.counters()
    timer.reset()
    n_masks = [len(r["scores"]) for r in res]
    assert c["predictor.masks"] == sum(n_masks) > 0
    assert c["predictor.masks_pasted_on_device"] == c["predictor.masks"]
    assert (kernels.launch_counts()["mask_paste"] - before
            == sum(n > 0 for n in n_masks))
    batches = [np.stack([imgs[0], imgs[2]]), imgs[1][None]]
    small = sum(v.nbytes for b in batches
                for k, v in pred.run_batch(b).items() if k != "masks")
    pasted = sum(n * img.shape[0] * img.shape[1]
                 for n, img in zip(n_masks, imgs))
    assert c["predictor.download_bytes"] == small + pasted
    assert _ranges(prof)["predictor.paste"] == len(imgs)
