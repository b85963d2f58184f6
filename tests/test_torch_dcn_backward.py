"""The backward of tpuseg_torch's DCN sampler (``ops/sampling.py``: the
autograd sampler and its plain backward ``sample_points_backward_plain``,
the plain version of ``csrc/dcn_sample_bwd.cu``) against autograd through
the plain forward, and ``deform_conv2d``'s gradients against ``jax.grad``
of tpuseg's ``deform_conv2d``: its gather path, and its Pallas path in
interpret mode (K4c, ``dcn_pl.py::_win_bwd_call``, at the windowed
geometries h >= 32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deform_conv import GEOMETRIES, K, _case, _nchw
from tpuseg.ops import deform_conv as JD
from tpuseg_torch.ops import deform_conv as D
from tpuseg_torch.ops import sampling
from tpuseg_torch.ops.sampling import (sample_points,
                                       sample_points_backward_plain,
                                       sample_points_plain)

# pytest-xdist runs several workers on the CPU's cores: more torch threads
# each would only oversubscribe them
torch.set_num_threads(2)


def _points(rng, b, s, h, w, dtype):
    """Samples over the map and 3 px past it, a quarter of the rows and of
    the columns on integers (borders included), a few wholly outside."""
    sy = rng.uniform(-3.0, h + 2.0, (b, s))
    sx = rng.uniform(-3.0, w + 2.0, (b, s))
    sy[:, : s // 4] = np.round(sy[:, : s // 4])
    sx[:, s // 8: 3 * s // 8] = np.round(sx[:, s // 8: 3 * s // 8])
    sy[:, -3:] = [-1.0, h - 1.0, h + 5.5]  # the border rows, and outside
    m = rng.uniform(0.05, 1.0, (b, s))
    return [torch.from_numpy(a).to(dtype) for a in (sy, sx, m)]


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("modulated", [True, False])
def test_plain_backward_matches_autograd(dtype, rtol, modulated,
                                         monkeypatch):
    """d feats, d sy, d sx (and d m) equal autograd through
    sample_points_plain (floor rule: one-sided at integers), to rtol and
    rtol * max|ref|; chunks over S change nothing; the autograd sampler
    returns exactly the plain backward on CPU tensors."""
    rng = np.random.default_rng(3)
    b, c, h, w, s = 2, 6, 9, 11, 400
    feats = torch.from_numpy(rng.standard_normal((b, c, h, w))).to(dtype)
    sy, sx, m = _points(rng, b, s, h, w, dtype)
    m = m if modulated else None
    grad = torch.from_numpy(rng.standard_normal((b, s, c))).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (feats, sy, sx)] + (
        [m.clone().requires_grad_()] if modulated else [])
    out = sample_points_plain(*leaves[:3], leaves[3] if modulated else None)
    want = torch.autograd.grad(out, leaves, grad)
    got = sample_points_backward_plain(grad, feats, sy, sx, m)
    assert (got[3] is None) == (not modulated)
    for g, r, name in zip(got, want, ("feats", "sy", "sx", "m")):
        assert g.dtype == dtype and g.shape == r.shape, name
        torch.testing.assert_close(g, r, rtol=rtol,
                                   atol=rtol * float(r.abs().max()),
                                   msg=name)
    # the points wholly outside get nothing
    assert not got[1][:, -1].any() and not got[2][:, -1].any()
    monkeypatch.setattr(sampling, "_POINT_CHUNK", 60)  # 5 samples a chunk
    chunked = sample_points_backward_plain(grad, feats, sy, sx, m)
    for g, r in zip(chunked[:len(leaves)], got):
        torch.testing.assert_close(g, r, rtol=rtol,
                                   atol=rtol * float(r.abs().max()))
    monkeypatch.undo()
    auto = torch.autograd.grad(sample_points(*leaves[:3], leaves[3] if
                                             modulated else None),
                               leaves, grad)
    for g, r in zip(auto, got):
        assert torch.equal(g, r)


def test_autograd_sampler_honours_needs_input_grad():
    """Only the features need a gradient: the coordinates' terms are not
    computed; only the coordinates: d feats is not."""
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((1, 3, 5, 6)))
    sy, sx, m = _points(rng, 1, 40, 5, 6, torch.float64)
    f = feats.clone().requires_grad_()
    (sample_points(f, sy, sx, m) ** 2).sum().backward()
    grad = 2 * sample_points_plain(feats, sy, sx, m)
    want = sample_points_backward_plain(grad, feats, sy, sx, m)
    torch.testing.assert_close(f.grad, want[0], rtol=1e-12, atol=1e-12)
    ys = sy.clone().requires_grad_()
    (sample_points(feats, ys, sx, m) ** 2).sum().backward()
    torch.testing.assert_close(ys.grad, want[1], rtol=1e-12, atol=1e-12)
    assert sample_points_backward_plain(grad, feats, sy, sx, m,
                                        coords_grad=False)[1:] == (None,) * 3
    assert sample_points_backward_plain(grad, feats, sy, sx, m,
                                        feats_grad=False)[0] is None


def _grads_port(x, offsets, mask, weight, bias, cot, stride, dil):
    """d(sum(out * cot)) w.r.t. x, offsets, mask, weight, bias (the JAX
    layouts: NHWC, HWIO)."""
    leaves = [_nchw(x), _nchw(offsets), _nchw(mask),
              torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()),
              torch.from_numpy(bias)]
    leaves = [t.requires_grad_() for t in leaves]
    out = D.deform_conv2d(*leaves, K, stride, dil, dil)
    (out * _nchw(cot)).sum().backward()
    to_nhwc = lambda t: t.grad.permute(0, 2, 3, 1).numpy()
    return [to_nhwc(leaves[0]), to_nhwc(leaves[1]), to_nhwc(leaves[2]),
            leaves[3].grad.permute(2, 3, 1, 0).numpy(), leaves[4].grad.numpy()]


def _grads_jax(x, offsets, mask, weight, bias, cot, stride, dil, method):
    def loss(*a):
        out = JD.deform_conv2d(*a, kernel=K, stride=stride, padding=dil,
                               dilation=dil, method=method)
        return jnp.sum(out * jnp.asarray(cot))

    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, (x, offsets, mask, weight, bias)))
    return [np.asarray(a) for a in g]


NAMES = ("x", "offsets", "mask", "weight", "bias")
# GEOMETRIES, then a zero-offset case: every sample on an integer
CASES = [g + (False,) for g in GEOMETRIES] + [(40, 48, 4, 4, 1, 1, 0.0, 0,
                                               True)]


@pytest.mark.parametrize("geom", CASES)
def test_deform_conv2d_gradients_match_jax(geom):
    """f32: against jax.grad of the gather path at 1e-5 of max|ref| per
    gradient (rtol 1e-5); against the Pallas path in interpret mode (dense
    K4a forward and jnp backward where h < 32, K4b forward and K4c backward
    where h >= 32) at 2e-4. Not d offsets against the Pallas path where
    samples sit on integers: K4c differentiates the hat max(0, 1 - |t - e|),
    whose sub-gradient at an integer takes the other side from the floor
    rule of the gather path, of upstream DCNv2 and of the port."""
    h, w, cin, cout, stride, dil, oscale, n_big, zero = geom
    rng = np.random.default_rng(h * 100 + w + 7)
    case = _case(rng, h, w, cin, cout, stride, dil, oscale, n_big)
    ho, wo = case[1].shape[1:3]
    cot = rng.standard_normal((2, ho, wo, cout)).astype(np.float32)
    got = _grads_port(*case, cot, stride, dil)
    for method, tol in (("gather", 1e-5), ("onehot", 2e-4)):
        want = _grads_jax(*case, cot, stride, dil, method)
        for name, g, r in zip(NAMES, got, want):
            if zero and method == "onehot" and name == "offsets":
                continue
            assert g.shape == r.shape, name
            np.testing.assert_allclose(g, r, rtol=tol,
                                       atol=tol * np.abs(r).max(),
                                       err_msg=f"{method} d {name}")
    if zero:  # the floor rule: the gradient in y at an integer is one-sided
        assert np.abs(got[1]).max() > 0
