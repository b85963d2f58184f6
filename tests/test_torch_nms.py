"""Plain NMS of tpuseg_torch against tpuseg's jnp NMS, its Pallas kernel in
interpret mode and its sequential golden. Keep masks must be identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_boxes import rand_boxes
from tpuseg.ops import nms as JN
from tpuseg.ops.pallas.nms_pl import nms_mask_pallas_batched
from tpuseg_torch.ops import nms as TN


def _inputs(rng, b, n, size=40.0, p_valid=0.7):
    boxes = np.stack([rand_boxes(rng, n, size=size) for _ in range(b)])
    scores = rng.standard_normal((b, n)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) < p_valid
    return boxes, scores, valid


def _port(boxes, scores, thr, valid, to_remove):
    return TN.nms_mask_batch(torch.from_numpy(boxes), torch.from_numpy(scores),
                             thr, torch.from_numpy(valid),
                             to_remove=to_remove).numpy()


@pytest.mark.parametrize("n", [1, 64, 200, 300])
@pytest.mark.parametrize("to_remove", [0.0, 1.0])
def test_plain_nms_matches_jnp_and_pallas_interpret(rng, n, to_remove):
    boxes, scores, valid = _inputs(rng, 2, n)
    got = _port(boxes, scores, 0.5, valid, to_remove)
    want = np.asarray(JN.nms_mask_batch(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, jnp.asarray(valid),
        use_pallas=False, to_remove=to_remove))
    np.testing.assert_array_equal(got, want)
    want_pl = np.asarray(nms_mask_pallas_batched(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, jnp.asarray(valid),
        interpret=True, to_remove=to_remove))
    np.testing.assert_array_equal(got, want_pl)


def test_plain_nms_matches_reference_ragged_and_ties(rng):
    """N = 819 (P6 at 800x1344, past 6 tiles of 128), tied scores, duplicate
    boxes and an all-invalid image, against the sequential golden."""
    boxes, scores, valid = _inputs(rng, 3, 819, size=80.0)
    scores = np.round(scores, 1)  # many ties
    boxes[0, 10:20] = boxes[0, 5]  # duplicates: IoU exactly 1
    valid[2] = False
    got = _port(boxes, scores, 0.7, valid, 1.0)
    assert not got[2].any()
    for i in range(3):
        want = np.asarray(JN.nms_mask_reference(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.7,
            jnp.asarray(valid[i]), to_remove=1.0))
        np.testing.assert_array_equal(got[i], want, err_msg=f"image {i}")


def test_resurrection_chain():
    # 0 suppresses 1; 1 is gone, so 2 (which only overlaps 1) survives
    chain = np.array([[[0, 0, 10, 10], [4, 0, 14, 10], [8, 0, 18, 10]]],
                     np.float32)
    keep = _port(chain, np.array([[0.9, 0.8, 0.7]], np.float32), 0.3,
                 np.ones((1, 3), bool), 0.0)
    np.testing.assert_array_equal(keep, [[True, False, True]])


def test_class_aware_matches_jax(rng):
    boxes, scores, valid = _inputs(rng, 2, 256, size=60.0)
    classes = rng.integers(0, 5, (2, 256))
    got = TN.batched_nms_mask_batch(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(classes), 0.5, torch.from_numpy(valid),
        to_remove=1.0).numpy()
    want = np.asarray(JN.batched_nms_mask_batch(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.5,
        valid=jnp.asarray(valid), use_pallas=False, to_remove=1.0))
    np.testing.assert_array_equal(got, want)
    # no suppression across classes: each class alone gives the same keep
    for c in range(5):
        sel = valid & (classes == c)
        alone = _port(boxes, scores, 0.5, sel, 1.0)
        np.testing.assert_array_equal(alone, got & sel)
