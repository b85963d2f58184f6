"""The detectron family's plain ops of tpuseg_torch against tpuseg's: the
adaptive RoIAlign (``sampling_ratio=0``, the C4 pooler's) in its separable
form (``group_size``) and its gather form, forward and feature gradient
(against ``jax.grad``), RoIPool, and the sigmoid focal loss, on the same
numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.ops import losses as JLO
from tpuseg.ops import sampling as JS
from tpuseg_torch.ops import losses as LO
from tpuseg_torch.ops import sampling as S

B, C, H, W = 2, 8, 30, 44  # a map of 480x704 px at stride 16
R = 12  # rois per image
SCALE = 1.0 / 16


def _rois(rng) -> np.ndarray:
    """[B*R, 4] image-coordinate rois: random ones, and in image 0 one
    that spans the image, a sub-pixel one, one across the bottom-right
    border, one wholly outside the map and one of zero extent."""
    xy = rng.uniform(-20, [W * 16 * 0.8, H * 16 * 0.8], (B * R, 2))
    wh = rng.uniform(0.3, 400, (B * R, 2))
    rois = np.concatenate([xy, xy + wh], -1)
    rois[0] = [0, 0, W * 16 - 1, H * 16 - 1]
    rois[1] = [5.2, 5.3, 5.9, 6.1]
    rois[2] = [W * 16 - 10, H * 16 - 8, W * 16 + 30, H * 16 + 20]
    rois[3] = [W * 16 + 40, H * 16 + 40, W * 16 + 90, H * 16 + 70]
    rois[4] = [100.0, 60.0, 100.0, 60.0]
    rois[R] = [-30, -30, W * 16 + 30, H * 16 + 30]
    return rois.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, H, W, C)).astype(np.float32), _rois(rng),
            np.repeat(np.arange(B), R).astype(np.int32),
            rng.standard_normal((B * R, C, 14, 14)).astype(np.float32))


def _port(feats, rois, bidx, p, sr, group):
    return S.roi_align(torch.from_numpy(feats).permute(0, 3, 1, 2),
                       torch.from_numpy(rois), torch.from_numpy(bidx), p,
                       SCALE, sr, group_size=R if group else None)


def _jax(feats, rois, bidx, p, sr, group):
    return JS.roi_align(feats, jnp.asarray(rois), jnp.asarray(bidx),
                        output_size=p, spatial_scale=SCALE, sampling_ratio=sr,
                        group_size=R if group else None)


@pytest.mark.parametrize("group", [True, False], ids=["separable", "gather"])
@pytest.mark.parametrize("p,sr", [(14, 0), (7, 0), (7, 2)])
def test_roi_align_matches_jax(data, group, p, sr):
    """Forward 1e-5 max|ref|; sampling_ratio 0 has a static bound of
    ceil(44 / P) samples a bin per axis (4 at P = 14, 7 at P = 7)."""
    feats, rois, bidx, _ = data
    got = _port(feats, rois, bidx, p, sr, group).permute(0, 2, 3, 1).numpy()
    want = np.asarray(_jax(jnp.asarray(feats), rois, bidx, p, sr, group))
    assert got.shape == want.shape == (B * R, p, p, C)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert not got[3].any()  # the roi outside the map pools zeros


@pytest.mark.parametrize("group", [True, False], ids=["separable", "gather"])
def test_adaptive_roi_align_feature_gradient_matches_jax_grad(data, group):
    """d(sum(pooled * g)) / d(feats) against jax.grad, 1e-5 max|ref|."""
    feats, rois, bidx, g = data
    ft = torch.from_numpy(feats).requires_grad_()
    out = S.roi_align(ft.permute(0, 3, 1, 2), torch.from_numpy(rois),
                      torch.from_numpy(bidx), 14, SCALE, 0,
                      group_size=R if group else None)
    (out * torch.from_numpy(g)).sum().backward()
    gt = jnp.asarray(g.transpose(0, 2, 3, 1))
    want = np.asarray(jax.grad(lambda f: jnp.sum(
        _jax(f, rois, bidx, 14, 0, group) * gt))(jnp.asarray(feats)))
    np.testing.assert_allclose(ft.grad.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_separable_and_gather_forms_agree(data):
    feats, rois, bidx, _ = data
    a = _port(feats, rois, bidx, 14, 0, True)
    b = _port(feats, rois, bidx, 14, 0, False)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max())


def test_separable_form_wants_grouped_rois(data):
    feats, rois, bidx, _ = data
    with pytest.raises(ValueError, match="images"):
        S.roi_align(torch.from_numpy(feats).permute(0, 3, 1, 2),
                    torch.from_numpy(rois), torch.from_numpy(bidx), 14,
                    SCALE, 0, group_size=R - 1)


@pytest.mark.parametrize("p", [7, 14])
def test_roi_pool_matches_jax(data, p):
    """Exact: max pooling moves no value; spanning, sub-pixel, border and
    outside rois (whose empty bins pool 0)."""
    feats, rois, bidx, _ = data
    got = S.roi_pool(torch.from_numpy(feats).permute(0, 3, 1, 2),
                     torch.from_numpy(rois), torch.from_numpy(bidx), p,
                     SCALE).permute(0, 2, 3, 1).numpy()
    want = np.asarray(JS.roi_pool(jnp.asarray(feats), jnp.asarray(rois),
                                  jnp.asarray(bidx), output_size=p,
                                  spatial_scale=SCALE))
    np.testing.assert_array_equal(got, want)
    assert not got[3].any()


def test_sigmoid_focal_loss_matches_jax():
    """Elementwise rtol 1e-6: background rows (0), every class, ignored
    rows (-1, -2), and logits out to +-30."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((64, 8)) * 4).astype(np.float32)
    logits[0, :2] = [30.0, -30.0]
    targets = rng.integers(-2, 9, 64).astype(np.int32)
    targets[:3] = [0, -1, 8]
    got = LO.sigmoid_focal_loss(torch.from_numpy(logits),
                                torch.from_numpy(targets)).numpy()
    want = np.asarray(JLO.sigmoid_focal_loss(jnp.asarray(logits),
                                             jnp.asarray(targets)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert not got[targets < 0].any() and got[targets >= 0].sum(1).all()
    for gamma, alpha in ((0.0, 0.5), (1.5, 0.1)):
        np.testing.assert_allclose(
            LO.sigmoid_focal_loss(torch.from_numpy(logits),
                                  torch.from_numpy(targets), gamma,
                                  alpha).numpy(),
            np.asarray(JLO.sigmoid_focal_loss(
                jnp.asarray(logits), jnp.asarray(targets), gamma, alpha)),
            rtol=1e-6, atol=1e-7)
