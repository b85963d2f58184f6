"""tpuseg_torch.core.boxes against tpuseg.core.boxes on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_boxes import rand_boxes
from tpuseg.core import boxes as JB
from tpuseg_torch.core import boxes as TB

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("to_remove", [0.0, 1.0])
def test_area_and_iou_match_jax(rng, to_remove):
    a = rand_boxes(rng, 40)
    b = rand_boxes(rng, 30)
    a[3] = a[3, [2, 3, 0, 1]]  # inverted box: extents clamp to 0
    np.testing.assert_allclose(
        _np(TB.area(torch.from_numpy(a), to_remove)),
        _np(JB.area(jnp.asarray(a), to_remove)), **TOL)
    np.testing.assert_allclose(
        _np(TB.iou_matrix(torch.from_numpy(a), torch.from_numpy(b),
                          to_remove=to_remove)),
        _np(JB.iou_matrix(jnp.asarray(a), jnp.asarray(b),
                          to_remove=to_remove)), **TOL)


def test_clip_to_image_matches_jax(rng):
    bx = (rand_boxes(rng, 50, size=300.0) - 60.0).reshape(2, 25, 4)
    hw = np.array([[199, 249], [119, 299]], np.int64)
    want = np.stack([_np(JB.clip_to_image(jnp.asarray(bx[i]), hw[i, 0] - 1,
                                          hw[i, 1] - 1)) for i in range(2)])
    got = TB.clip_to_image(torch.from_numpy(bx),
                           torch.from_numpy(hw[:, 0] - 1)[:, None],
                           torch.from_numpy(hw[:, 1] - 1)[:, None])
    np.testing.assert_allclose(_np(got), want, **TOL)


@pytest.mark.parametrize("k,weights", [(1, (1.0, 1.0, 1.0, 1.0)),
                                       (5, (10.0, 10.0, 5.0, 5.0))])
def test_decode_boxes_matches_jax(rng, k, weights):
    anchors = rand_boxes(rng, 64, size=200.0)
    deltas = rng.standard_normal((64, 4 * k)).astype(np.float32)
    deltas[:4, 2:4] = 30.0  # exp argument past BBOX_XFORM_CLIP
    want = _np(JB.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors),
                               weights=weights))
    got = _np(TB.decode_boxes(torch.from_numpy(deltas),
                              torch.from_numpy(anchors), weights=weights))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0),
                                     (10.0, 10.0, 5.0, 5.0)])
def test_encode_boxes_matches_jax_and_inverts_decode(rng, weights):
    anchors = rand_boxes(rng, 64, size=200.0)
    boxes = rand_boxes(rng, 64, size=200.0)
    boxes[0] = boxes[0, [2, 3, 0, 1]]  # inverted: extents clamp at 1e-6
    want = _np(JB.encode_boxes(jnp.asarray(boxes), jnp.asarray(anchors),
                               weights))
    got = TB.encode_boxes(torch.from_numpy(boxes), torch.from_numpy(anchors),
                          weights)
    # rtol 1e-6: the same float32 formula; atol 1e-5 for log/div rounding
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-5)
    back = TB.decode_boxes(got[1:], torch.from_numpy(anchors[1:]), weights)
    np.testing.assert_allclose(_np(back), boxes[1:], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n,k", [(50, 20), (12, 20)])
def test_masked_topk_matches_jax_with_ties(rng, n, k):
    # few distinct values: many ties, which a stable sort must break by
    # index exactly as jax.lax.top_k does
    scores = rng.integers(0, 4, (3, n)).astype(np.float32) * 0.25
    valid = rng.uniform(size=(3, n)) > 0.3
    ws, wi, wv = (np.asarray(x) for x in JB.masked_topk(
        jnp.asarray(scores), jnp.asarray(valid), k))
    gs, gi, gv = (x.numpy() for x in TB.masked_topk(
        torch.from_numpy(scores), torch.from_numpy(valid), k))
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi[gv], wi[wv])
    np.testing.assert_array_equal(gs, ws)
    # the JAX padding slots (k > n) carry index 0, as ours do
    np.testing.assert_array_equal(gi[:, min(n, k):], wi[:, min(n, k):])
