"""DCNv2 of tpuseg_torch (``ops/deform_conv.py``, the plain point sampler
of ``ops/sampling.py``) against tpuseg's ``deform_conv2d``: its gather
path, and its Pallas paths in interpret mode (the dense kernel K4a where
h < 32, the windowed kernel K4b where h >= 32 and w > 32), at the
geometries of ``tests/test_deform_conv.py``. The port's tensors are NCHW,
the JAX package's NHWC."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuseg.ops import deform_conv as JD
from tpuseg.ops.sampling import _cols_gather_flat
from tpuseg_torch.ops import deform_conv as D
from tpuseg_torch.ops import sampling
from tpuseg_torch.ops.sampling import sample_points, sample_points_plain

K = 3


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _case(rng, h, w, cin, cout, stride, dil, oscale, n_big=0, b=2):
    ho = (h + 2 * dil - dil * (K - 1) - 1) // stride + 1
    wo = (w + 2 * dil - dil * (K - 1) - 1) // stride + 1
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    offsets = (rng.standard_normal((b, ho, wo, 2 * K * K))
               * oscale).astype(np.float32)
    if n_big:  # samples that escape the TPU kernel's window
        flat = offsets.reshape(-1)
        pick = rng.choice(flat.size, n_big, replace=False)
        flat[pick] = rng.uniform(8, 25, n_big) * rng.choice([-1, 1], n_big)
    mask = rng.uniform(0.2, 1.0, (b, ho, wo, K * K)).astype(np.float32)
    weight = rng.standard_normal((K, K, cin, cout)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x, offsets, mask, weight, bias


def _port(x, offsets, mask, weight, bias, stride, dil):
    w_oihw = torch.from_numpy(weight.transpose(3, 2, 0, 1).copy())
    out = D.deform_conv2d(_nchw(x), _nchw(offsets), _nchw(mask), w_oihw,
                          torch.from_numpy(bias), K, stride, dil, dil)
    return out.permute(0, 2, 3, 1).numpy()


def _jax(x, offsets, mask, weight, bias, stride, dil, method):
    return np.asarray(JD.deform_conv2d(
        *map(jnp.asarray, (x, offsets, mask, weight, bias)), kernel=K,
        stride=stride, padding=dil, dilation=dil, method=method))


# (h, w, cin, cout, stride, dilation, offset scale, escapes): dense K4a
# geometries (h < 32), one with most samples wholly outside the map, then
# windowed K4b geometries, in the window, with escapes, at stride 2
GEOMETRIES = [(8, 9, 4, 6, 1, 1, 1.5, 0), (10, 7, 8, 8, 2, 1, 3.0, 0),
              (9, 9, 4, 4, 1, 2, 25.0, 0), (18, 18, 16, 8, 1, 1, 1.5, 0),
              (40, 48, 4, 4, 1, 1, 1.5, 0), (40, 48, 4, 4, 1, 1, 1.5, 30),
              (47, 41, 4, 4, 2, 1, 1.0, 5)]


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_deform_conv2d_matches_jax_gather_and_pallas(geom):
    """f32 against the gather path at rtol = atol = 1e-5; against the
    Pallas path (interpret mode, dense where h < 32, windowed otherwise)
    at 2e-4, the JAX package's own tolerance between its two paths."""
    h, w, cin, cout, stride, dil, oscale, n_big = geom
    rng = np.random.default_rng(h * 100 + w)
    case = _case(rng, h, w, cin, cout, stride, dil, oscale, n_big)
    windowed = JD._win_geometry(h, w, K * K, stride, dil) is not None
    assert windowed == (h >= 32)
    got = _port(*case, stride, dil)
    np.testing.assert_allclose(got, _jax(*case, stride, dil, "gather"),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _jax(*case, stride, dil, "onehot"),
                               rtol=2e-4, atol=2e-4)


def test_zero_offsets_unit_mask_is_a_conv():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 6, 11, 13))
                         .astype(np.float32))
    weight = torch.from_numpy(rng.standard_normal((5, 6, 3, 3)).astype(
        np.float32))
    bias = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    for stride in (1, 2):
        ho, wo = (11 - 1) // stride + 1, (13 - 1) // stride + 1
        got = D.deform_conv2d(x, torch.zeros(2, 18, ho, wo),
                              torch.ones(2, 9, ho, wo), weight, bias, 3,
                              stride, 1, 1)
        want = F.conv2d(x, weight, bias, stride=stride, padding=1)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_modulated_deform_conv_matches_dcn_block(stride):
    """Offsets from the first 2kk channels of ``conv_offset_mask``,
    interleaved (dy, dx) per tap, the modulation the sigmoid of the last
    kk: the port's module against ``dcn_block`` on the same weights."""
    rng = np.random.default_rng(stride)
    cin, cout = 8, 6
    x = rng.standard_normal((2, 15, 17, cin)).astype(np.float32)
    p = {"offset": {"weight": (rng.standard_normal((3, 3, cin, 27))
                               * 0.5).astype(np.float32),
                    "bias": rng.standard_normal(27).astype(np.float32)},
         "weight": rng.standard_normal((3, 3, cin, cout)).astype(np.float32),
         "bias": rng.standard_normal(cout).astype(np.float32)}
    mod = D.ModulatedDeformConv2d(cin, cout, 3, stride=stride)
    sd = {"weight": p["weight"].transpose(3, 2, 0, 1),
          "bias": p["bias"],
          "conv_offset_mask.weight":
              p["offset"]["weight"].transpose(3, 2, 0, 1),
          "conv_offset_mask.bias": p["offset"]["bias"]}
    mod.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = mod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(JD.dcn_block(jnp.asarray(x), jax_tree(p),
                                   stride=stride))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def jax_tree(p: dict) -> dict:
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in p.items()}


def test_sample_points_plain_matches_cols_gather(monkeypatch):
    """Corners past every border, samples wholly outside; f32 and f64
    features; without and with the modulation (the JAX function has none:
    it is applied after the corner sum)."""
    rng = np.random.default_rng(7)
    b, h, w, c, s = 2, 9, 13, 5, 777
    feats = rng.standard_normal((b, h, w, c)).astype(np.float32)
    sy = rng.uniform(-3, h + 2, (b, s)).astype(np.float32)
    sx = rng.uniform(-3, w + 2, (b, s)).astype(np.float32)
    m = rng.uniform(0, 1, (b, s)).astype(np.float32)
    want = np.asarray(_cols_gather_flat(*map(jnp.asarray, (feats, sy, sx))))
    f = _nchw(feats)
    t = [torch.from_numpy(a) for a in (sy, sx, m)]
    np.testing.assert_allclose(sample_points_plain(f, t[0], t[1]).numpy(),
                               want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        sample_points_plain(f.double(), t[0], t[1], t[2]).numpy(),
        want * m[..., None], rtol=1e-6, atol=1e-6)
    # on CPU tensors the dispatcher runs the plain version; its chunks over
    # S (here 7 samples of 2 x 5 channels) change nothing
    whole = sample_points(f, *t)
    assert whole.dtype == torch.float32 and whole.shape == (b, s, c)
    monkeypatch.setattr(sampling, "_POINT_CHUNK", 70)
    np.testing.assert_array_equal(sample_points(f, *t).numpy(), whole.numpy())
