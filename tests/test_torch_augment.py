"""YOLACT's training augmentation and targets of tpuseg_torch
(``data/augment.py``, ``engine/yolact_train_loop.py::build_targets_np``,
without cv2) against tpuseg's (``tpuseg/data/augment.py`` and
``tpuseg/engine/yolact_train_loop.py``, on cv2), from one
``np.random.default_rng`` seed each: the same draws in the same order
(the generators end in the same state), images within 2e-3 (normalised
units; cv2's bilinear resize rounds its float weights otherwise than
``F.interpolate``), boxes rtol 1e-5, classes and crowds equal, and masks
equal except where the interpolated value lies within 1e-3 of 0.5."""
import cv2
import numpy as np
import pytest

from tpuseg.data import augment as JA
from tpuseg.engine.yolact_train_loop import build_targets_np as j_targets
from tpuseg_torch.data import augment as A
from tpuseg_torch.engine.yolact_train_loop import build_targets_np

SIZE = 96
PROTO, SEM = 24, 12


def _example(seed: int):
    """A textured RGB image with 6 elliptic masks, one of them a crowd."""
    rng = np.random.default_rng(100 + seed)
    h, w, g = 120 + 7 * seed, 160 - 5 * seed, 6
    img = np.kron(rng.uniform(0, 255, (h // 20 + 1, w // 20 + 1, 3)),
                  np.ones((20, 20, 1)))[:h, :w] + rng.normal(0, 20, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    wh = rng.uniform(0.15, 0.5, (g, 2)) * [w, h]
    xy = rng.uniform(0, 1, (g, 2)) * ([w, h] - wh)
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    masks = np.stack([((xx - (a + c) / 2) / ((c - a) / 2)) ** 2
                      + ((yy - (b + d) / 2) / ((d - b) / 2)) ** 2 <= 1
                      for a, b, c, d in boxes]).astype(np.uint8)
    classes = rng.integers(0, 80, g)
    crowd = np.zeros(g, bool)
    crowd[-1] = True
    return img, boxes, classes, masks, crowd


def _near_half(masks: np.ndarray, size: int) -> np.ndarray:
    """Pixels whose bilinear value lies within 1e-3 of 0.5."""
    if not len(masks):
        return np.zeros((0, size, size), bool)
    return np.stack([np.abs(A.resize_bilinear(m.astype(np.float32), size)
                            - 0.5) < 1e-3 for m in masks])


def _pre_resize_masks(seed: int, ex, cfg) -> np.ndarray:
    """The masks just before ssd_augment's resize, less the boxes its
    discard drops: the same stages on a generator with the same seed."""
    img, boxes, classes, masks, crowd = ex
    rng = np.random.default_rng(seed)
    img = A.photometric_distort(rng, img)
    img, boxes, masks = A.expand(rng, img, boxes, masks, cfg.mean)
    img, boxes, _, masks, _ = A.random_sample_crop(rng, img, boxes, classes,
                                                   masks, iscrowd=crowd)
    img, boxes, masks = A.random_mirror(rng, img, boxes, masks)
    h, w = img.shape[:2]
    bw = (boxes[:, 2] - boxes[:, 0]) / w * cfg.size
    bh = (boxes[:, 3] - boxes[:, 1]) / h * cfg.size
    keep = (bw > cfg.discard_box_width) & (bh > cfg.discard_box_height)
    return masks[keep] if len(masks) else masks


def _assert_masks(got, want, near, name):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    bad = (got != want) & ~near
    assert not bad.any(), f"{name}: {int(bad.sum())} pixels differ"


@pytest.mark.parametrize("seed", range(8))
def test_ssd_augment_and_targets_match_jax(seed):
    ex = _example(seed)
    cfg, jcfg = A.AugmentConfig(size=SIZE), JA.AugmentConfig(size=SIZE)
    rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    got = A.ssd_augment(rng_p, *ex[:4], cfg, iscrowd=ex[4])
    want = JA.ssd_augment(rng_j, *ex[:4], jcfg, iscrowd=ex[4])
    assert rng_p.bit_generator.state == rng_j.bit_generator.state
    img, boxes, classes, masks, crowd = got
    assert img.shape == (SIZE, SIZE, 3) and img.dtype == np.float32
    np.testing.assert_allclose(img, want[0], rtol=0, atol=2e-3)
    np.testing.assert_allclose(boxes, want[1], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(classes, want[2])
    np.testing.assert_array_equal(crowd, want[4])
    pre = _pre_resize_masks(seed, ex, cfg)
    _assert_masks(masks, want[3], _near_half(pre, SIZE), "masks")

    gt = {"boxes": boxes, "classes": classes, "masks": want[3],
          "iscrowd": crowd}
    tg = build_targets_np(gt, SIZE, PROTO, SEM, 8)
    jt = j_targets(gt, SIZE, PROTO, SEM, 8)
    assert tg.keys() == jt.keys()
    for k in ("boxes", "classes", "crowd"):
        assert tg[k].dtype == jt[k].dtype, k
        np.testing.assert_array_equal(tg[k], jt[k], err_msg=k)
    n = min(len(classes), 8)
    for k, size in (("masks_proto", PROTO), ("masks_sem", SEM)):
        near = np.zeros((8, size, size), bool)
        near[:n] = _near_half(want[3][:n], size)
        _assert_masks(tg[k], jt[k], near, k)


def test_hsv_conversions_match_cv2():
    """cv2's float RGB<->HSV on pixels the jitter leaves outside 0..255,
    grey pixels (no hue) and every hue sector: S and V equal, H within
    1e-4 degrees, the round trip within 1e-4 of cv2's."""
    rng = np.random.default_rng(0)
    img = rng.uniform(-40, 300, (40, 60, 3)).astype(np.float32)
    img[:4] = img[:4, :, :1]  # grey
    hsv = A.rgb_to_hsv(img)
    want = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    np.testing.assert_array_equal(hsv[..., 1:], want[..., 1:])
    np.testing.assert_allclose(hsv[..., 0], want[..., 0], rtol=0, atol=1e-4)
    want[..., 1] *= 1.3
    want[..., 0] = (want[..., 0] + 17.0) % 360.0
    np.testing.assert_allclose(A.hsv_to_rgb(want),
                               cv2.cvtColor(want, cv2.COLOR_HSV2RGB),
                               rtol=0, atol=1e-4)
