"""tpuseg_torch's YOLOv3 training targets and loss against tpuseg's, on
the CPU: ``build_targets`` equal (ground truths on the right and bottom
edges, and two that pick the same cell and anchor) and the loss terms in
f32 within rtol 1e-4. The training step is in
tests/test_torch_yolov3_step.py."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpuseg.models import yolov3 as JY
from tpuseg.models import yolov3_loss as JL
from tpuseg_torch.models import yolov3 as TY
from tpuseg_torch.models import yolov3_loss as TL

torch.set_num_threads(2)

LEVEL_HW = [(4, 4), (8, 8), (16, 16)]  # a 128 px input


def gts(rng, b: int, g: int, size: int) -> tuple:
    """b images of g ground truths in a size x size input, the last two
    of each padded; image 0's first two pick one cell and anchor, its
    third is centred on the right edge, its fourth on the bottom edge."""
    c = rng.uniform(8, size - 8, (b, g, 2))
    wh = rng.uniform(6, size * 0.9, (b, g, 2))
    c[0, 1] = c[0, 0] + 0.1  # the same cell, the same wh: the same anchor
    wh[0, 1] = wh[0, 0] * 1.01
    c[0, 2, 0] = size
    c[0, 3, 1] = size
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    classes = rng.integers(0, 80, (b, g)).astype(np.int32)
    classes[:, -2:] = -1
    boxes[:, -2:] = 0
    return boxes, classes


def test_build_targets_match_tpuseg():
    """Every level's targets equal (txywh within 1e-6: the two frameworks'
    f32 logs), image by image and batched: the edge ground
    truths land in the last cell with offset 1.0, and image 0's duplicate
    fills one slot."""
    cfg = TY.YoloV3Config(input_size=128)
    jbuild = jax.jit(lambda b, c: JL.build_targets(
        b, c, LEVEL_HW, JY.YoloV3Config(input_size=128)))
    rng = np.random.default_rng(0)
    boxes, classes = gts(rng, 3, 12, 128)
    got_b = TL.build_targets_batch(torch.from_numpy(boxes),
                                   torch.from_numpy(classes), LEVEL_HW, cfg)
    for i in range(3):
        want = jbuild(jnp.asarray(boxes[i]), jnp.asarray(classes[i]))
        got = TL.build_targets(torch.from_numpy(boxes[i]),
                               torch.from_numpy(classes[i]), LEVEL_HW, cfg)
        for li, ((jc, jx, jl), (tc, tx, tl)) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                                       atol=1e-6)
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
            for t, b in zip((tc, tx, tl), got_b[li]):
                assert torch.equal(t, b[i])
        assigned = sum(int((t[0] > 0).sum()) for t in got)
        valid = int((classes[i] >= 0).sum())
        # image 0's first two ground truths share a slot
        assert assigned < valid if i == 0 else assigned <= valid


def test_duplicate_slot_takes_the_later_ground_truth():
    """Two ground truths on one cell and anchor: both packages keep the
    one with the larger index, whichever order they come in."""
    cfg = TY.YoloV3Config(input_size=128, num_classes=4)
    jcfg = JY.YoloV3Config(input_size=128, num_classes=4)
    boxes = np.asarray([[14, 19, 114, 109], [15, 20, 115, 110],
                        [0, 0, 0, 0]], np.float32)
    jbuild = jax.jit(lambda b, c: JL.build_targets(b, c, LEVEL_HW, jcfg))
    for order in ([0, 1, 2], [1, 0, 2]):
        b, c = boxes[order], np.asarray([1, 2, -1], np.int32)
        want = jbuild(jnp.asarray(b), jnp.asarray(c))
        got = TL.build_targets(torch.from_numpy(b), torch.from_numpy(c),
                               LEVEL_HW, cfg)
        tconf, txywh, tcls = got[0]
        (slot,) = torch.nonzero(tconf).flatten().tolist()
        assert int(tcls[slot]) == 2  # the later one
        assert int(np.asarray(want[0][2])[slot]) == 2
        np.testing.assert_allclose(txywh[slot].numpy(),
                                   np.asarray(want[0][1])[slot], atol=1e-6)


def test_total_loss_matches_tpuseg():
    """Every term in f32 within rtol 1e-4, on raw maps that put some
    predictions over a ground truth (the ignore mask at work)."""
    cfg = TY.YoloV3Config(input_size=128)
    jcfg = JY.YoloV3Config(input_size=128)
    rng = np.random.default_rng(1)
    boxes, classes = gts(rng, 2, 10, 128)
    outs = [rng.standard_normal((2, h, w, 3 * 85)).astype(np.float32) * 0.5
            for h, w in LEVEL_HW]
    want = jax.jit(lambda o, b, c: JL.total_loss(o, b, c, jcfg))(
        [jnp.asarray(o) for o in outs], jnp.asarray(boxes),
        jnp.asarray(classes))
    got = TL.total_loss([torch.from_numpy(o) for o in outs],
                        torch.from_numpy(boxes), torch.from_numpy(classes),
                        cfg)
    assert got.keys() == want.keys()
    for k in want:
        assert float(got[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    with torch.no_grad():  # the ignore mask removes some noobj terms
        dec = TY.decode([torch.from_numpy(o) for o in outs], cfg)[0]
        from tpuseg_torch.core.boxes import iou_matrix

        iou = iou_matrix(dec, torch.from_numpy(boxes))
    assert (iou.amax(-1) > 0.5).sum() > 0
