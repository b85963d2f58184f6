"""The plain RoIAlign backward of tpuseg_torch (the plain version of the
backward kernel, ``csrc/roi_align_bwd.cu``) and the differentiable pooler,
against autograd of the plain forward, gradcheck, tpuseg's Pallas backward
kernel in interpret mode, and jax.grad of tpuseg's jnp pooler."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_roi_align_pl import _setup
from tpuseg.ops import sampling as JS
from tpuseg.ops.pallas.roi_align_pl import (clamp_levels_to_window as j_clamp,
                                            multilevel_roi_align_pallas_bwd)
from tpuseg_torch.ops import sampling as TS

# pytest-xdist runs several workers on the CPU's cores: more torch threads
# each would only oversubscribe them
torch.set_num_threads(2)

STRIDES = (4, 8, 16, 32)


def _case(rng, n=12, p=7, kind="mixed"):
    """_setup's inputs (4 levels, B = 2, C = 128), levels clamped to the
    32 x 32 windows that the interpret-mode Pallas kernel applies itself,
    and a d(pooled) [N, P, P, C] in the JAX layout. ``kind`` "tiny": boxes
    of 0.5-6 px on P2, every roi's samples in one or two cells a side;
    "border": boxes of 20-100 px reaching up to 40 px past the image."""
    feats, strides, boxes, bi, levels = _setup(rng, n=n)
    if kind == "tiny":
        xy = rng.uniform(0, 250, (n, 2))
        boxes = jnp.asarray(np.concatenate(
            [xy, xy + rng.uniform(0.5, 6, (n, 2))], 1).astype(np.float32))
        levels = jnp.zeros(n, jnp.int32)
    elif kind == "border":
        xy = rng.uniform(-40, 240, (n, 2))
        boxes = jnp.asarray(np.concatenate(
            [xy, xy + rng.uniform(20, 100, (n, 2))], 1).astype(np.float32))
        levels = jnp.asarray(rng.integers(0, 2, n).astype(np.int32))
    levels = j_clamp(feats, boxes, levels, strides, rows=32, span=32)
    g = rng.standard_normal((n, p, p, feats[0].shape[-1])).astype(np.float32)
    return feats, boxes, bi, levels, g


def _torch_args(feats, boxes, bi, levels, g):
    shapes = [(f.shape[0], f.shape[3], f.shape[1], f.shape[2]) for f in feats]
    return (torch.from_numpy(g).permute(0, 3, 1, 2),
            torch.from_numpy(np.array(boxes)), torch.from_numpy(np.array(bi)),
            torch.from_numpy(np.array(levels)), shapes)


def _plain_bwd(feats, boxes, bi, levels, g, p, dtype=torch.float32):
    grad, tb, tbi, tl, shapes = _torch_args(feats, boxes, bi, levels, g)
    return TS.multilevel_roi_align_backward_plain(
        grad.to(dtype), tb, tbi, tl, shapes, dtype, p, 2, STRIDES)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("p,n,kind", [
    pytest.param(7, 12, "mixed", id="7-12"),
    pytest.param(14, 6, "mixed", id="14-6"),
    pytest.param(7, 10, "tiny", id="tiny-7-10"),
    pytest.param(14, 6, "border", id="border-14-6")])
def test_plain_backward_matches_pallas_bwd_and_jax_grad(rng, p, n, kind):
    """The plain backward, the kernel's yardstick on the card, against
    tpuseg's Pallas backward (interpret mode) and jax.grad, also on the
    rois that stress the kernel's merging (tiny) and its border
    rules (past the image)."""
    feats, boxes, bi, levels, g = _case(rng, n, p, kind)
    got = _plain_bwd(feats, boxes, bi, levels, g, p)
    want_pl = multilevel_roi_align_pallas_bwd(
        feats, boxes, bi, levels, jnp.asarray(g), output_size=p,
        sampling_ratio=2, strides=STRIDES, rows=32, span=32, interpret=True)

    def loss(fs):
        out = JS.multilevel_roi_align(fs, boxes, bi, levels, output_size=p,
                                      sampling_ratio=2, strides=STRIDES)
        return jnp.sum(out * g)

    want_grad = jax.grad(loss)(feats)
    for lv in range(4):
        assert got[lv].shape == (2, 128) + feats[lv].shape[1:3]
        # rtol 1e-4 / atol 1e-5 (the values reach ~10): both references
        # add the same contributions in other orders, the Pallas kernel
        # through f32 matmuls of its interpolation matrices, jax.grad by
        # XLA's scatter-add of the gather's transpose. A tiny roi piles up
        # to 784 adds of either sign into one cell (values to ~14, some
        # summing near 0), so there the rounding scales with the level's
        # largest value: atol 1e-5 max|ref|, the card's tolerance
        atol = 1e-5
        if kind == "tiny":
            atol *= max(1.0, float(np.abs(np.asarray(want_grad[lv])).max()))
        np.testing.assert_allclose(_nhwc(got[lv]), np.asarray(want_pl[lv]),
                                   rtol=1e-4, atol=atol)
        np.testing.assert_allclose(_nhwc(got[lv]), np.asarray(want_grad[lv]),
                                   rtol=1e-4, atol=atol)
    assert sum(float(t.abs().sum()) for t in got) > 0


def test_plain_backward_is_the_transpose_of_the_plain_forward(rng):
    feats, boxes, bi, levels, g = _case(rng, 10, 7)
    grad, tb, tbi, tl, shapes = _torch_args(feats, boxes, bi, levels, g)
    tf = [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2).requires_grad_()
          for f in feats]
    out = TS.multilevel_roi_align_plain(tf, tb, tbi, tl, 7, 2, STRIDES)
    want = torch.autograd.grad((out * grad).sum(), tf)
    got = TS.multilevel_roi_align_backward_plain(grad, tb, tbi, tl, shapes,
                                                 torch.float32, 7, 2, STRIDES)
    for a, b in zip(got, want):
        # the same products, summed in another order: f32 rounding only
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_pooler_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    feats = [torch.randn(2, 3, h, w, generator=g, dtype=torch.float64)
             .requires_grad_() for h, w in ((12, 16), (6, 8))]
    boxes = torch.tensor([[2.0, 3.0, 30.0, 40.0], [-6.0, 10.0, 20.0, 50.0],
                          [40.0, 8.0, 66.0, 30.0], [10.5, 10.5, 11.0, 11.2]])
    bi = torch.tensor([0, 1, 1, 0])
    levels = torch.tensor([0, 1, 0, 1])

    def pooler(*fs):
        return TS.multilevel_roi_align(list(fs), boxes, bi, levels, 3, 2,
                                       STRIDES[:2])

    assert torch.autograd.gradcheck(pooler, tuple(feats), eps=1e-6,
                                    atol=1e-7, rtol=1e-6)


def test_pooler_grads_accumulate_into_channels_last_leaves(rng):
    """Two poolers on the same channels-last levels (as the box and mask
    heads share them): ``.grad`` is the sum of the two plain backwards, in
    the levels' shapes."""
    feats, boxes, bi, levels, g7 = _case(rng, 8, 7)
    g14 = rng.standard_normal((8, 14, 14, 128)).astype(np.float32)
    grad7, tb, tbi, tl, shapes = _torch_args(feats, boxes, bi, levels, g7)
    grad14 = torch.from_numpy(g14).permute(0, 3, 1, 2)
    base = [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2)
            .contiguous().requires_grad_() for f in feats]
    cl = [f.contiguous(memory_format=torch.channels_last) for f in base]
    out7 = TS.multilevel_roi_align(cl, tb, tbi, tl, 7, 2, STRIDES)
    out14 = TS.multilevel_roi_align(cl, tb, tbi, tl, 14, 2, STRIDES)
    ((out7 * grad7).sum() + (out14 * grad14).sum()).backward()
    want7 = TS.multilevel_roi_align_backward_plain(grad7, tb, tbi, tl, shapes,
                                                   torch.float32, 7, 2, STRIDES)
    want14 = TS.multilevel_roi_align_backward_plain(
        grad14, tb, tbi, tl, shapes, torch.float32, 14, 2, STRIDES)
    for f, a, b in zip(base, want7, want14):
        assert f.grad.shape == f.shape
        torch.testing.assert_close(f.grad, a + b, rtol=1e-6, atol=1e-6)


def test_bf16_backward_accumulates_in_f32_and_rounds_once(rng):
    """bf16 features and d(pooled): the f32 sum of the same products, cast
    to bf16 once at the end (exactly, not to a tolerance)."""
    feats, boxes, bi, levels, g = _case(rng, 10, 7)
    g_bf = np.array(torch.from_numpy(g).to(torch.bfloat16).float())
    got = _plain_bwd(feats, boxes, bi, levels, g_bf, 7, torch.bfloat16)
    want = _plain_bwd(feats, boxes, bi, levels, g_bf, 7)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))
