"""Plain RoIAlign, level clamp and level assignment of tpuseg_torch against
tpuseg's jnp pooler, its Pallas kernel in interpret mode, and its clamp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_roi_align_pl import _setup
from tpuseg.models.maskrcnn import assign_levels as j_assign_levels
from tpuseg.ops import sampling as JS
from tpuseg.ops.pallas.roi_align_pl import (clamp_levels_to_window as j_clamp,
                                            multilevel_roi_align_pallas)
from tpuseg_torch.models.maskrcnn import assign_levels
from tpuseg_torch.ops import sampling as TS

TOL = dict(rtol=1e-4, atol=1e-4)


def _to_torch(feats, boxes, bi, levels, dtype=torch.float32):
    tf = [torch.from_numpy(np.array(f, np.float32)).permute(0, 3, 1, 2)
          .to(dtype) for f in feats]
    return (tf, torch.from_numpy(np.array(boxes)),
            torch.from_numpy(np.array(bi)), torch.from_numpy(np.array(levels)))


@pytest.mark.parametrize("p,n", [(7, 16), (14, 8)])
def test_plain_roi_align_matches_jnp_and_pallas(rng, p, n):
    feats, strides, boxes, bi, levels = _setup(rng, n=n)
    tf, tb, tbi, tl = _to_torch(feats, boxes, bi, levels)
    got = TS.multilevel_roi_align(tf, tb, tbi, tl, p, 2, strides)
    assert got.shape == (n, 128, p, p)
    got = got.permute(0, 2, 3, 1).numpy()
    want = np.asarray(JS.multilevel_roi_align(
        feats, boxes, bi, levels, output_size=p, sampling_ratio=2,
        strides=strides))
    np.testing.assert_allclose(got, want, **TOL)
    want_pl = np.asarray(multilevel_roi_align_pallas(
        feats, boxes, bi, levels, output_size=p, sampling_ratio=2,
        strides=strides, rows=32, span=32, interpret=True))
    np.testing.assert_allclose(got, want_pl, **TOL)


def test_border_rules_match_jnp(rng):
    """Boxes reaching past the map (samples beyond [-1, H] pool as 0, the
    rest clamp to the border) and degenerate boxes (w, h < 1)."""
    feats, strides, _, _, _ = _setup(rng, n=4)
    boxes = jnp.asarray(np.array([
        [-30.0, -30.0, 20.0, 20.0],
        [200.0, 220.0, 300.0, 290.0],
        [50.0, 50.0, 50.2, 50.1],
        [-500.0, 10.0, -450.0, 40.0],
    ], np.float32))
    bi = jnp.asarray(np.array([0, 1, 0, 1], np.int32))
    levels = jnp.asarray(np.array([0, 1, 0, 2], np.int32))
    tf, tb, tbi, tl = _to_torch(feats, boxes, bi, levels)
    got = TS.multilevel_roi_align(tf, tb, tbi, tl, 7, 2, strides)
    want = np.asarray(JS.multilevel_roi_align(
        feats, boxes, bi, levels, output_size=7, sampling_ratio=2,
        strides=strides))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    assert not want[3].any()  # wholly outside: zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clamp_levels_matches_jax(rng, dtype):
    """Includes the extreme-aspect boxes of test_roi_align_pl.py; the clamp
    depends on the dtype through the window's column alignment."""
    feats, strides, boxes, _, _ = _setup(rng, n=64)
    extreme = np.array([[4.0, 100.0, 252.0, 112.0], [100.0, 4.0, 118.0, 250.0],
                        [0.0, 0.0, 255.0, 255.0], [40.0, 40.0, 90.0, 96.0]],
                       np.float32)
    boxes = np.concatenate([np.asarray(boxes), extreme])
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jfeats = tuple(f.astype(jd) for f in feats)
    raw = j_assign_levels(jnp.asarray(boxes))
    np.testing.assert_array_equal(
        assign_levels(torch.from_numpy(boxes)).numpy(), np.asarray(raw))
    tf = [torch.from_numpy(np.array(f, np.float32)).permute(0, 3, 1, 2).to(td)
          for f in feats]
    for rows, span in ((44, 64), (32, 32)):
        want = np.asarray(j_clamp(jfeats, jnp.asarray(boxes), raw, strides,
                                  rows=rows, span=span))
        got = TS.clamp_levels_to_window(
            tf, torch.from_numpy(boxes), torch.from_numpy(np.array(raw)),
            strides, rows=rows, span=span)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want[-4] > np.asarray(raw)[-4]  # the wide box moved up a level


def test_bf16_plain_path(rng):
    """bf16 features: sums in f32, one rounding to bf16 at the end."""
    feats, strides, boxes, bi, levels = _setup(rng, n=8)
    tf, tb, tbi, tl = _to_torch(feats, boxes, bi, levels, torch.bfloat16)
    got = TS.multilevel_roi_align(tf, tb, tbi, tl, 7, 2, strides)
    assert got.dtype == torch.bfloat16
    want = TS.multilevel_roi_align([f.float() for f in tf], tb, tbi, tl, 7, 2,
                                   strides)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.to(torch.bfloat16).float().numpy())
