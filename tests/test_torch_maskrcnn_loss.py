"""The Mask R-CNN losses of tpuseg_torch against tpuseg's, function by
function, on the same numpy inputs and the JAX package's own uniform
draws (the key tree of ``forward_train_losses``: per image
``kp, kn = split(k_i)``, then ``uniform(kp, (n,))``, ``uniform(kn, (n,))``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.models import maskrcnn as JM
from tpuseg.models import maskrcnn_loss as JL
from tpuseg_torch.models import maskrcnn_loss as TL

# pytest-xdist runs several workers on the CPU's cores: more torch threads
# each would only oversubscribe them
torch.set_num_threads(2)


def jax_draws(key, n: int) -> tuple:
    """The two uniform vectors balanced_sample draws from ``key``."""
    kp, kn = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.uniform(k, (n,))))
                 for k in (kp, kn))


def jax_draws_per_image(key, b: int, n: int) -> list:
    return [jax_draws(k, n) for k in jax.random.split(key, b)]


def _boxes(rng, shape, lo=0.0, hi=200.0, size=(8.0, 90.0)):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(*size, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("low_quality", [False, True])
def test_match_targets_matches_jax(rng, low_quality):
    gt = _boxes(rng, (6,))
    gv = np.array([True, True, True, True, False, True])
    anchors = np.concatenate([_boxes(rng, (300,)), gt[:3],
                              gt[:2] + 1.0])  # exact and near duplicates
    anchor_valid = rng.uniform(size=anchors.shape[0]) > 0.1
    for av in (None, anchor_valid):
        wi, wl = JL.match_targets(jnp.asarray(gt), jnp.asarray(gv),
                                  jnp.asarray(anchors), 0.7, 0.3, low_quality,
                                  None if av is None else jnp.asarray(av))
        gi, gl = TL.match_targets(_t(gt), _t(gv), _t(anchors), 0.7, 0.3,
                                  low_quality, None if av is None else _t(av))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        assert {-1, 0, 1} <= set(gl.tolist())


@pytest.mark.parametrize("n_pos,batch,frac", [(10, 64, 0.5), (40, 64, 0.25),
                                              (3, 32, 0.25)])
def test_balanced_sample_matches_jax_draws(rng, n_pos, batch, frac):
    lab = np.concatenate([np.ones(n_pos), np.zeros(300),
                          -np.ones(60)]).astype(np.int32)
    lab = lab[rng.permutation(lab.size)]
    key = jax.random.PRNGKey(n_pos)
    wi, wp, wv = (np.asarray(x) for x in JL.balanced_sample(
        jnp.asarray(lab), key, batch, frac))
    gi, gp, gv = (x.numpy() for x in TL.balanced_sample(
        _t(lab).long(), *jax_draws(key, lab.size), batch, frac))
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gi[gv], wi[wv])
    assert gv.sum() == batch


def test_positive_prefix_invariant():
    """The mask branch pools only the first roi_batch * pos_fraction
    sampled slots, which is right only because balanced_sample's stable
    compaction puts every positive there (under-, exactly- and
    over-subscribed positives against the cap)."""
    for n_pos in (3, 16, 40):
        lab = np.concatenate([np.ones(n_pos), np.zeros(300),
                              -np.ones(50)]).astype(np.int32)
        lab = lab[np.random.default_rng(n_pos).permutation(lab.size)]
        g = torch.Generator().manual_seed(n_pos)
        _, sel_pos, sel_valid = TL.balanced_sample(
            _t(lab).long(), torch.rand(lab.size, generator=g),
            torch.rand(lab.size, generator=g), 64, 0.25)
        sp = (sel_pos & sel_valid).numpy()
        m = 16
        assert not sp[m:].any(), f"positive beyond prefix (n_pos={n_pos})"
        k = int(sp.sum())
        assert k == min(n_pos, m) and sp[:k].all()


def _rpn_case(rng):
    cfg = JM.MaskRCNNConfig()
    canvas = (64, 96)
    anchors_l = JM.make_anchors_np(cfg, *canvas)
    anchors = np.concatenate(anchors_l)
    n = anchors.shape[0]
    b = 2
    hw = np.array([[64, 96], [48, 80]], np.int32)
    inside = np.concatenate([np.asarray(JM.anchor_inside_mask(
        jnp.asarray(hw), st, *JM.fpn_level_hw(*canvas, st), 3))
        for st in cfg.anchor_stride], 1)
    gt = _boxes(rng, (b, 5), hi=50.0, size=(10.0, 40.0))
    gv = np.array([[True] * 4 + [False], [True] * 3 + [False] * 2])
    obj = rng.standard_normal((b, n)).astype(np.float32)
    dl = (rng.standard_normal((b, n, 4)) * 0.3).astype(np.float32)
    return anchors, hw, inside, gt, gv, obj, dl


def test_rpn_loss_matches_jax(rng):
    anchors, hw, inside, gt, gv, obj, dl = _rpn_case(rng)
    cfg_j = JL.MaskRCNNLossConfig(rpn_batch_per_image=64)
    cfg_t = TL.MaskRCNNLossConfig(rpn_batch_per_image=64)
    key = jax.random.PRNGKey(7)
    want = JL.rpn_loss(jnp.asarray(obj), jnp.asarray(dl), jnp.asarray(anchors),
                       jnp.asarray(gt), jnp.asarray(gv), key, cfg_j,
                       image_hw=jnp.asarray(hw),
                       anchor_inside=jnp.asarray(inside))
    got = TL.rpn_loss(_t(obj), _t(dl), _t(anchors), _t(gt), _t(gv),
                      jax_draws_per_image(key, 2, anchors.shape[0]), cfg_t,
                      image_hw=_t(hw).long(), anchor_inside=_t(inside))
    assert want.keys() == got.keys()
    for k in want:
        # same samples, f32 sums in another order
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
        assert float(got[k]) > 0


def test_sample_proposals_and_box_head_loss_match_jax(rng):
    nc = 9
    cfg_j = JL.MaskRCNNLossConfig(num_classes=nc, roi_batch_per_image=64)
    cfg_t = TL.MaskRCNNLossConfig(num_classes=nc, roi_batch_per_image=64)
    gt = _boxes(rng, (6,), size=(30.0, 90.0))
    gc = rng.integers(0, nc - 1, 6).astype(np.int32)
    gv = np.array([True] * 5 + [False])
    # proposals: jittered copies of the gts (positives) and random boxes
    props = np.concatenate([gt[:5].repeat(8, 0) + rng.normal(0, 6, (40, 4)),
                            _boxes(rng, (160,))]).astype(np.float32)
    pv = rng.uniform(size=200) > 0.1
    key = jax.random.PRNGKey(3)
    want = JL.sample_proposals(*(jnp.asarray(a) for a in (props, pv, gt, gc,
                                                          gv)), key, cfg_j)
    got = TL.sample_proposals(_t(props), _t(pv), _t(gt), _t(gc), _t(gv),
                              *jax_draws(key, 206), cfg_t)
    for k in ("pos", "valid", "cls_target"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    v = got["valid"].numpy()
    assert got["pos"].sum() > 4 and v.sum() == 64
    np.testing.assert_array_equal(got["gt_idx"].numpy()[v],
                                  np.asarray(want["gt_idx"])[v])
    np.testing.assert_array_equal(got["boxes"].numpy()[v],
                                  np.asarray(want["boxes"])[v])
    np.testing.assert_allclose(got["reg_target"].numpy()[v],
                               np.asarray(want["reg_target"])[v],
                               rtol=1e-5, atol=1e-5)

    logits = rng.standard_normal((64, nc)).astype(np.float32)
    deltas = rng.standard_normal((64, nc * 4)).astype(np.float32)
    wl = JL.box_head_loss(jnp.asarray(logits), jnp.asarray(deltas), want,
                          cfg_j)
    gl = TL.box_head_loss(_t(logits), _t(deltas), got, cfg_t)
    for k in wl:
        np.testing.assert_allclose(float(gl[k]), float(wl[k]), rtol=1e-5)


def test_mask_targets_and_mask_loss_match_jax(rng):
    g, r, s, m = 4, 32, 24, 28
    gt = _boxes(rng, (g,), size=(30.0, 90.0))
    # blob masks: a smooth field thresholded, so targets are not noise
    yy, xx = np.mgrid[:r, :r] / r
    crops = np.stack([(np.sin(6 * xx + i) * np.cos(5 * yy - i) > -0.2)
                      for i in range(g)]).astype(np.float32)
    gi = rng.integers(0, g, s)
    rois = (gt[gi] + rng.normal(0, 5, (s, 4))).astype(np.float32)
    want = np.asarray(JL.mask_targets_from_crops(
        jnp.asarray(rois), jnp.asarray(gi), jnp.asarray(gt),
        jnp.asarray(crops), m))
    got = TL.mask_targets_from_crops(_t(rois), _t(gi), _t(gt), _t(crops), m)
    assert got.shape == (s, m, m)
    # the JAX package pools through f32 interpolation matmuls, the port
    # by a gather: a value within rounding of 0.5 may threshold either way
    assert (got.numpy() != want).mean() <= 1e-3
    assert 0.2 < want.mean() < 0.8

    x = rng.standard_normal((s, m, m)).astype(np.float32) * 2
    pos = rng.uniform(size=s) > 0.3
    cfg_j, cfg_t = JL.MaskRCNNLossConfig(), TL.MaskRCNNLossConfig()
    wl = JL.mask_head_loss_selected(jnp.asarray(x), {"pos": jnp.asarray(pos)},
                                    jnp.asarray(want), cfg_j)
    gl = TL.mask_head_loss_selected(_t(x), {"pos": _t(pos)}, _t(want), cfg_t)
    np.testing.assert_allclose(float(gl["loss_mask"]), float(wl["loss_mask"]),
                               rtol=1e-5)


def test_roi_align_aligned_matches_jax(rng):
    feats = rng.standard_normal((2, 20, 24, 3)).astype(np.float32)
    rois = _boxes(rng, (10,), lo=-10.0, hi=70.0, size=(0.5, 40.0))
    bi = rng.integers(0, 2, 10).astype(np.int32)
    from tpuseg.ops.sampling import roi_align as j_roi_align
    from tpuseg_torch.ops.sampling import roi_align

    for aligned, scale in ((True, 0.25), (False, 0.5)):
        want = np.asarray(j_roi_align(jnp.asarray(feats), jnp.asarray(rois),
                                      jnp.asarray(bi), output_size=5,
                                      spatial_scale=scale, sampling_ratio=2,
                                      aligned=aligned))
        got = roi_align(_t(feats).permute(0, 3, 1, 2), _t(rois), _t(bi), 5,
                        scale, 2, aligned)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-5, atol=1e-5)
