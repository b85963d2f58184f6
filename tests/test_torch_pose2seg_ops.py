"""tpuseg_torch's Pose2Seg host math and AffineAlign against tpuseg's, on
the CPU: templates, the affine solve, template choice, theta, skeleton
features (numpy on both sides: equal), ``affine_grid``, ``affine_align``
forward and d feats on tpuseg's gather route and on its window-kernel
route (K4b and K4c in interpret mode), the paste's ``grid_sample`` and the
ground-truth warp."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuseg.models import pose2seg as JP
from tpuseg.models import pose2seg_loss as JL
from tpuseg.ops import sampling as JS
from tpuseg_torch.models import pose2seg as TP
from tpuseg_torch.models import pose2seg_loss as TL
from tpuseg_torch.ops import sampling as TS

torch.set_num_threads(2)


def _pose(rng, tpl, visible=17):
    """A template under a random similarity transform with noise, in px;
    ``visible`` keypoints visible (the rest at visibility 0)."""
    ang, size = rng.uniform(-0.6, 0.6), rng.uniform(40, 300)
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    kp = np.zeros((17, 3))
    kp[:, :2] = (tpl + rng.normal(0, 0.02, (17, 2))) @ rot.T * size \
        + rng.uniform(0, 200, 2)
    kp[rng.permutation(17)[:visible], 2] = rng.integers(1, 3)
    return kp


@pytest.mark.parametrize("visible", [17, 9, 2, 1])
def test_host_math_equals_tpuseg(visible):
    """choose_template, solve_similarity, template_oks, affine_to_theta,
    inverse_theta, gen_skeleton_feats and skeleton_feats_for_person on
    random poses (all, some, two and one keypoint visible): equal to
    tpuseg's, bit for bit (the same numpy steps)."""
    rng = np.random.default_rng(visible)
    cfg, jcfg = TP.Pose2SegConfig(), JP.Pose2SegConfig()
    np.testing.assert_array_equal(TP.templates(cfg), JP.templates(jcfg))
    for i in range(6):
        kp = _pose(rng, JP.templates()[i % 3], visible)
        got, want = TP.choose_template(kp, cfg), JP.choose_template(kp, jcfg)
        assert got[1:] == want[1:]
        if want[0] is None:
            assert got[0] is None and visible < 2
            continue
        np.testing.assert_array_equal(got[0], want[0])
        valid = kp[:, 2] > 0
        dst = JP.templates()[1]
        a, b = (TP.solve_similarity(kp[:, :2], dst, valid),
                JP.solve_similarity(kp[:, :2], dst, valid))
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
        assert (TP.template_oks(kp, dst, a[0], valid)
                == JP.template_oks(kp, dst, b[0], valid))
        for h, w in ((512, 512), (96, 140)):
            np.testing.assert_array_equal(TP.affine_to_theta(want[0], h, w),
                                          JP.affine_to_theta(want[0], h, w))
            np.testing.assert_array_equal(TP.inverse_theta(want[0], h, w),
                                          JP.inverse_theta(want[0], h, w))
        np.testing.assert_array_equal(
            TP.skeleton_feats_for_person(kp, want[0], cfg),
            JP.skeleton_feats_for_person(kp, want[0], jcfg))
    assert TP.solve_similarity(np.zeros((17, 2)), np.zeros((17, 2)),
                               np.ones(17, bool)) == (None, np.inf)


@pytest.mark.parametrize("layout", ["pixels", "unit"])
def test_templates_json_equals_tpuseg(tmp_path, layout):
    """An upstream-style templates.json (a dict of named poses with
    visibility, in pixels; or a bare list in the unit frame): the same
    templates as tpuseg reads, and the same template chosen."""
    rng = np.random.default_rng(5)
    tpls = np.stack([JP._STAND, JP._UPPER]) + rng.normal(0, 0.01, (2, 17, 2))
    if layout == "pixels":
        data = {f"pose{i}": np.concatenate(
            [t * [120, 200] + 30, np.full((17, 1), 2.0)], 1).tolist()
            for i, t in enumerate(tpls)}
    else:
        data = tpls.tolist()
    path = tmp_path / f"templates_{layout}.json"
    path.write_text(json.dumps(data))
    got = TP.load_templates_json(str(path))
    np.testing.assert_array_equal(got, JP.load_templates_json(str(path)))
    cfg = TP.Pose2SegConfig(template_file=str(path))
    np.testing.assert_array_equal(TP.templates(cfg), got)
    kp = _pose(rng, got[1])
    assert TP.choose_template(kp, cfg)[1:] == JP.choose_template(
        kp, JP.Pose2SegConfig(template_file=str(path)))[1:]


def _thetas(rng, n, scale=(0.3, 0.9)):
    th = np.zeros((n, 2, 3), np.float32)
    for i in range(n):
        s, a = rng.uniform(*scale), rng.uniform(-0.5, 0.5)
        th[i, :, :2] = s * np.array([[np.cos(a), -np.sin(a)],
                                     [np.sin(a), np.cos(a)]])
        th[i, :, 2] = rng.uniform(-0.7, 0.7, 2)
    return th


def test_affine_grid_equals_tpuseg():
    """affine_grid within one rounding of tpuseg's (its einsum sums the
    three terms in another order), and F.affine_grid's function."""
    th = _thetas(np.random.default_rng(0), 5)
    got = TS.affine_grid(torch.from_numpy(th), 24, 40)
    want = np.asarray(JS.affine_grid(jnp.asarray(th), 24, 40))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.4e-7)
    ref = F.affine_grid(torch.from_numpy(th), (5, 1, 24, 40),
                        align_corners=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=4.8e-7)


# (H, W, C, out, people, crop scales): tpuseg's gather route (C not a
# multiple of 128) and its window route (32x32x128: K4b / K4c in interpret
# mode), there also with crops of 4-5 source px per output px, whose
# samples escape their tile's 32x32 window, and crops past the border
ALIGN_CASES = {
    "gather": (24, 20, 16, 16, 3, (0.3, 0.9)),
    "window": (32, 32, 128, 16, 2, (0.3, 0.9)),
    "window_escaping": (32, 32, 128, 16, 2, (4.0, 5.0)),
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_affine_align_equals_tpuseg(case):
    """Forward within 1e-5 max|ref| (measured 3.2e-6 and below: the grid's
    last bit, tpuseg's pairwise corner sums and its window kernel's sums)
    and d feats against jax.grad within 1e-5 max|ref| (measured 1.9e-6 and
    below; the window route's backward is K4c in interpret mode)."""
    h, w, c, o, n, scale = ALIGN_CASES[case]
    rng = np.random.default_rng(len(case))
    f = rng.standard_normal((2, h, w, c)).astype(np.float32)
    th = _thetas(rng, 2 * n, scale).reshape(2, n, 2, 3)
    cot = rng.standard_normal((2, n, o, o, c)).astype(np.float32)
    assert JS._affine_align_eligible(h, w, c, o, 4) == (case != "gather")

    def jloss(ff):
        out = JS.affine_align(ff, jnp.asarray(th), o)
        return jnp.sum(out * cot), out

    (_, want), dwant = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(f))
    ft = torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_()
    got = TS.affine_align(ft, torch.from_numpy(th), o)
    (got * torch.from_numpy(cot)).sum().backward()
    want, dwant = np.asarray(want), np.asarray(dwant)
    assert got.shape == want.shape == (2, n, o, o, c)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    dgot = ft.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(dgot, dwant, rtol=0,
                               atol=1e-5 * np.abs(dwant).max())
    assert (want == 0).any()  # crops past the map


def test_paste_equals_tpuseg_grid_sample():
    """The paste (F.grid_sample over the affine grid) against tpuseg's
    grid_sample on its dense one-hot route: within 4e-6 (measured 1.5e-6,
    where the two grids differ in their last bit)."""
    rng = np.random.default_rng(3)
    fg = rng.uniform(0, 1, (4, 16, 16)).astype(np.float32)
    th = _thetas(rng, 4, (1.0, 3.0))
    assert 16 * 16 <= JS._DENSE_GRID_SAMPLE_MAX
    want = JS.grid_sample(jnp.asarray(fg)[..., None],
                          JS.affine_grid(jnp.asarray(th), 40, 40))[..., 0]
    got = TP.paste(torch.from_numpy(fg), torch.from_numpy(th), 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=4e-6)


def test_gt_warp_equals_tpuseg():
    """warp_gt_to_aligned: each of B x P binary masks under its own theta
    (one channel, the gather route on both sides), within 1e-5 (measured
    3.8e-6, where the grids differ in their last bit), and the
    aligned cross-entropy of random logits within rtol 1e-6."""
    rng = np.random.default_rng(4)
    gt = (rng.uniform(0, 1, (2, 3, 40, 40)) < 0.4).astype(np.float32)
    th = _thetas(rng, 6).reshape(2, 3, 2, 3)
    want = np.asarray(JL.warp_gt_to_aligned(jnp.asarray(gt), jnp.asarray(th),
                                            16))
    got = TL.warp_gt_to_aligned(torch.from_numpy(gt), torch.from_numpy(th),
                                16)
    assert got.shape == want.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    logits = rng.standard_normal((2, 3, 16, 16, 2)).astype(np.float32)
    valid = np.array([[True, True, False], [True, False, False]])
    tgt = (want > 0.5).astype(np.float32)
    jl = JL.aligned_ce_loss(jnp.asarray(logits), jnp.asarray(tgt),
                            jnp.asarray(valid))
    tl = TL.aligned_ce_loss(torch.from_numpy(logits), torch.from_numpy(tgt),
                            torch.from_numpy(valid))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
