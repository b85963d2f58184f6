"""The CUDA kernels of tpuseg_torch against their plain versions, on the
card. Marked ``cuda``; each test skips (inside the test) where there is no
CUDA device. This file imports no jax, so on a machine without jax it runs
without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from tpuseg_torch import kernels
from tpuseg_torch.models.maskrcnn import assign_levels
from tpuseg_torch.ops import nms as nms_ops
from tpuseg_torch.ops import deform_conv, sampling

pytestmark = pytest.mark.cuda


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _boxes(rng, shape, extent=(200.0, 320.0)):
    xy = rng.uniform(0, 1, shape + (2,)) * np.array(extent[::-1]) * 0.8
    wh = rng.uniform(4, 80, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 819, 1000, 2047, 2048, 2049,
                               6000, 12000])
@pytest.mark.parametrize("to_remove", [0.0, 1.0])
def test_nms_kernel_matches_plain(n, to_remove):
    """B = 3, the last image all invalid; scores rounded to 0.01 (ties), a
    run of boxes repeated with one score in image 0 (heavy duplicates);
    N up to the C4 budget 12 000 (188 row blocks, several staged pieces
    per row block)."""
    dev = _device()
    rng = np.random.default_rng(n)
    boxes = torch.from_numpy(_boxes(rng, (3, n))).to(dev)
    scores = torch.from_numpy(rng.uniform(size=(3, n)).round(2)
                              .astype(np.float32)).to(dev)
    dup = slice(n // 3, n // 3 + max(1, n // 10))
    boxes[0, dup] = boxes[0, n // 3].clone()
    scores[0, dup] = scores[0, n // 3].clone()
    valid = torch.from_numpy(rng.uniform(size=(3, n)) < 0.8).to(dev)
    valid[2] = False
    before = kernels.launch_counts()["nms"]
    got = nms_ops.nms_mask_batch(boxes, scores, 0.5, valid, to_remove=to_remove)
    assert kernels.launch_counts()["nms"] == before + 1
    with kernels.force_plain():
        want = nms_ops.nms_mask_batch(boxes, scores, 0.5, valid,
                                      to_remove=to_remove)
    assert torch.equal(got, want)
    assert not got[2].any()


def test_nms_kernel_writes_keep_in_the_boxes_order(monkeypatch):
    """The kernel reads the boxes through the sort's order and writes the
    keep mask in the boxes' own order: nms_keep under a random permutation
    equals the plain NMS, and nms_mask_batch's kernel path runs no scatter
    (nor the zeros it used to scatter into) in torch."""
    dev = _device()
    rng = np.random.default_rng(7)
    n = 1500
    boxes = torch.from_numpy(_boxes(rng, (2, n))).to(dev)
    scores = torch.from_numpy(rng.uniform(size=(2, n)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(2, n)) < 0.9).to(dev)
    with kernels.force_plain():
        want = nms_ops.nms_mask_batch(boxes, scores, 0.6, valid)
    from tpuseg_torch.kernels.nms import nms_keep

    svalid, order = nms_ops._sort_desc(scores, valid)
    assert not torch.equal(order, torch.arange(n, device=dev).expand(2, n))
    assert torch.equal(nms_keep(boxes, order, svalid, 0.6), want)

    def forbidden(*args, **kwargs):
        raise AssertionError("a scatter in torch on the kernel path")

    monkeypatch.setattr(torch.Tensor, "scatter_", forbidden)
    monkeypatch.setattr(torch, "zeros_like", forbidden)
    assert torch.equal(nms_ops.nms_mask_batch(boxes, scores, 0.6, valid), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [7, 14])
def test_roi_align_kernel_matches_plain(dtype, p):
    dev = _device()
    g = torch.Generator().manual_seed(p)
    feats = [torch.randn(2, 64, h, w, generator=g).to(dev, dtype)
             for h, w in ((50, 80), (25, 40), (13, 20), (7, 10))]
    rng = np.random.default_rng(p)
    boxes = torch.from_numpy(_boxes(rng, (300,))).to(dev)
    boxes[:5] -= 30.0  # past the top-left border
    bidx = torch.from_numpy(rng.integers(0, 2, 300)).to(dev)
    levels = sampling.clamp_levels_to_window(feats, boxes, assign_levels(boxes))
    before = kernels.launch_counts()["roi_align"]
    got = sampling.multilevel_roi_align(feats, boxes, bidx, levels, p, 2)
    assert kernels.launch_counts()["roi_align"] == before + 1
    assert got.shape == (300, 64, p, p) and got.dtype == dtype
    with kernels.force_plain():
        want = sampling.multilevel_roi_align(feats, boxes, bidx, levels, p, 2)
    # both sum in one fixed order with IEEE-rounded steps: equal bit for bit
    assert torch.equal(got, want)


def _assert_bwd_close(got, want_f32, dtype):
    """f32: atomics add in an order that changes from run to run, so the
    kernel meets the plain backward to rounding, atol 1e-5 max|ref| and
    rtol 1e-5. bf16 features: against the plain backward computed in f32,
    the kernel's one rounding to bf16 (2^-8 |ref|) plus 1e-3."""
    for g, w in zip(got, want_f32):
        assert g.dtype == dtype and g.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-5,
                                       atol=1e-5 * float(w.abs().max()))
        else:
            assert bool(((g.float() - w).abs()
                         <= 2.0 ** -8 * w.abs() + 1e-3).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [7, 14])
def test_roi_align_backward_kernel_matches_plain(dtype, p):
    dev = _device()
    g = torch.Generator().manual_seed(10 + p)
    shapes = [(2, 64, h, w) for h, w in ((50, 80), (25, 40), (13, 20), (7, 10))]
    rng = np.random.default_rng(p)
    boxes = torch.from_numpy(_boxes(rng, (300,))).to(dev)
    boxes[:5] -= 30.0  # past the top-left border
    bidx = torch.from_numpy(rng.integers(0, 2, 300)).to(dev)
    feats = [torch.zeros(sh, device=dev, dtype=dtype) for sh in shapes]
    levels = sampling.clamp_levels_to_window(feats, boxes, assign_levels(boxes))
    grad = torch.randn(300, 64, p, p, generator=g).to(dev, dtype)
    before = kernels.launch_counts()["roi_align_bwd"]
    got = sampling.multilevel_roi_align_backward(grad, boxes, bidx, levels,
                                                 shapes, dtype, p, 2)
    assert kernels.launch_counts()["roi_align_bwd"] == before + 1
    with kernels.force_plain():
        want = sampling.multilevel_roi_align_backward(
            grad.float(), boxes, bidx, levels, shapes, torch.float32, p, 2)
    _assert_bwd_close(got, want, dtype)


def test_pooler_autograd_uses_both_kernels():
    """The differentiable pooler on channels-last CUDA levels: one forward
    and one backward launch, and .grad equal to the backward kernel's
    output for the same d(pooled)."""
    dev = _device()
    g = torch.Generator().manual_seed(3)
    feats = [torch.randn(2, 64, h, w, generator=g).to(dev)
             .contiguous(memory_format=torch.channels_last).requires_grad_()
             for h, w in ((50, 80), (25, 40), (13, 20), (7, 10))]
    rng = np.random.default_rng(3)
    boxes = torch.from_numpy(_boxes(rng, (200,))).to(dev)
    bidx = torch.from_numpy(rng.integers(0, 2, 200)).to(dev)
    levels = sampling.clamp_levels_to_window(feats, boxes, assign_levels(boxes))
    dp = torch.randn(200, 64, 7, 7, generator=g).to(dev)
    kernels.reset_launch_counts()
    out = sampling.multilevel_roi_align(feats, boxes, bidx, levels, 7, 2)
    (out * dp).sum().backward()
    assert kernels.launch_counts() == {"nms": 0, "roi_align": 1,
                                       "roi_align_bwd": 1, "dcn_sample": 0,
                                       "dcn_sample_bwd": 0}
    want = sampling.multilevel_roi_align_backward(
        dp, boxes, bidx, levels, [f.shape for f in feats], torch.float32, 7, 2)
    _assert_bwd_close([f.grad for f in feats], want, torch.float32)


def _points(rng, b, s, h, w):
    """Sample rows and columns spread over the map and 2 px past its
    border, 5 % of them far outside, and a modulation in (0, 1)."""
    sy = rng.uniform(-2.0, h + 1.0, (b, s))
    sx = rng.uniform(-2.0, w + 1.0, (b, s))
    far = rng.uniform(size=(b, s)) < 0.05
    sy[far] += rng.choice([-1.0, 1.0], far.sum()) * rng.uniform(8, 25, far.sum())
    m = rng.uniform(0.05, 1.0, (b, s))
    return [torch.from_numpy(a.astype(np.float32)) for a in (sy, sx, m)]


@pytest.mark.parametrize("c", [3, 64, 128, 130, 512])
@pytest.mark.parametrize("modulated", [True, False])
def test_dcn_sample_kernel_matches_plain(c, modulated):
    """S = 1001 (not a multiple of the 256-thread block), samples past the
    border, wholly outside and (a quarter of the rows, a tenth of the
    points in both) on integer coordinates; C = 3 and 130 take the ragged
    path (no 16-byte vectors). f32 and bf16 equal to the plain version bit
    for bit (IEEE-rounded steps in one order on both sides); bf16 also
    within the output's one rounding, 2^-8 |ref| + 1e-3, of the plain
    version computed in f32 on the same bf16 values."""
    dev = _device()
    rng = np.random.default_rng(c)
    b, h, w, s = 2, 19, 23, 1001
    sy, sx, m = (t.to(dev) for t in _points(rng, b, s, h, w))
    sy[:, :250] = torch.round(sy[:, :250])
    sx[:, :100] = torch.round(sx[:, :100])
    m = m if modulated else None
    feats = torch.from_numpy(rng.standard_normal((b, c, h, w))
                             .astype(np.float32)).to(dev)
    before = kernels.launch_counts()["dcn_sample"]
    got = sampling.sample_points(feats, sy, sx, m)
    assert kernels.launch_counts()["dcn_sample"] == before + 1
    assert got.shape == (b, s, c) and got.dtype == torch.float32
    want = sampling.sample_points_plain(feats, sy, sx, m)
    assert torch.equal(got, want)
    assert bool((got[:, :, 0] == 0).any())  # some samples wholly outside
    fb = feats.bfloat16()
    got_bf = sampling.sample_points(fb, sy, sx, m)
    assert got_bf.dtype == torch.bfloat16
    assert torch.equal(got_bf, sampling.sample_points_plain(fb, sy, sx, m))
    ref = sampling.sample_points_plain(fb.float(), sy, sx, m)
    assert bool(((got_bf.float() - ref).abs()
                 <= 2.0 ** -8 * ref.abs() + 1e-3).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dcn_sample_kernel_on_unaligned_storage(dtype):
    """Features whose storage starts one element past a 16-byte boundary
    (channels-last, C = 128): the kernel takes its narrow path and still
    equals the plain version bit for bit."""
    dev = _device()
    rng = np.random.default_rng(11)
    b, c, h, w, s = 2, 128, 19, 23, 777
    sy, sx, m = (t.to(dev) for t in _points(rng, b, s, h, w))
    flat = torch.from_numpy(rng.standard_normal(b * h * w * c + 1).astype(
        np.float32)).to(dev, dtype)
    feats = flat[1:].view(b, h, w, c).permute(0, 3, 1, 2)
    assert feats.is_contiguous(memory_format=torch.channels_last)
    assert feats.data_ptr() % 16
    got = sampling.sample_points(feats, sy, sx, m)
    assert torch.equal(got, sampling.sample_points_plain(feats, sy, sx, m))


def _assert_points_bwd_close(got, want, dtype):
    """d feats: f32 atol 1e-5 max|ref| / rtol 1e-5 (atomics add in an order
    that changes from run to run); bf16 features: the one rounding of the
    f32 sum to bf16 against the plain backward in f32, 2^-8 |ref| + 1e-3.
    d sy, d sx, d m (f32 for either): rtol 1e-5 / atol 1e-6 max|ref| (the
    warp's sum over the channels runs in another order)."""
    df, *coords = got
    wdf, *wcoords = want
    assert df.dtype == dtype and df.shape == wdf.shape
    if dtype == torch.float32:
        torch.testing.assert_close(df, wdf, rtol=1e-5,
                                   atol=1e-5 * float(wdf.abs().max()))
    else:
        assert bool(((df.float() - wdf).abs()
                     <= 2.0 ** -8 * wdf.abs() + 1e-3).all())
    for g, w in zip(coords, wcoords):
        if w is None:
            assert g is None
            continue
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 128, 512])
@pytest.mark.parametrize("modulated", [True, False])
def test_dcn_sample_backward_kernel_matches_plain(dtype, c, modulated):
    """S = 1001 samples over the map, past its border and wholly outside,
    a quarter of them on integer rows; against
    sample_points_backward_plain computed in f32 on the same values."""
    dev = _device()
    rng = np.random.default_rng(10 + c)
    b, h, w, s = 2, 19, 23, 1001
    sy, sx, m = (t.to(dev) for t in _points(rng, b, s, h, w))
    sy[:, :250] = torch.round(sy[:, :250])
    m = m if modulated else None
    feats = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(
        np.float32)).to(dev, dtype).contiguous(memory_format=torch.channels_last)
    grad = torch.from_numpy(rng.standard_normal((b, s, c)).astype(
        np.float32)).to(dev, dtype)
    from tpuseg_torch.kernels.dcn import sample_points_backward

    before = kernels.launch_counts()["dcn_sample_bwd"]
    got = sample_points_backward(grad, feats, sy, sx, m)
    assert kernels.launch_counts()["dcn_sample_bwd"] == before + 1
    want = sampling.sample_points_backward_plain(grad.float(), feats.float(),
                                                 sy, sx, m)
    _assert_points_bwd_close(got, want, dtype)
    # only what is asked for
    df, dsy, dsx, dm = sample_points_backward(grad, feats, sy, sx, m,
                                              coords_grad=False)
    assert dsy is None and dsx is None and dm is None
    _assert_points_bwd_close((df, None, None, None), (want[0], None, None,
                                                      None), dtype)
    df, *coords = sample_points_backward(grad, feats, sy, sx, m,
                                         feats_grad=False)
    assert df is None
    _assert_points_bwd_close((want[0].to(dtype), *coords), want, dtype)


def test_deform_conv2d_gradients_on_the_card_match_plain():
    """The autograd sampler on the card: deform_conv2d gives x, the offsets
    and the modulation the gradients of the plain path
    (kernels.force_plain()), through one dcn_sample and one
    dcn_sample_bwd launch. Before the sampler had a backward on the card,
    these three got no gradient at all there."""
    dev = _device()
    rng = np.random.default_rng(5)
    b, cin, cout, h, w = 2, 64, 32, 21, 17
    x = torch.from_numpy(rng.standard_normal((b, cin, h, w)).astype(
        np.float32)).to(dev)
    off = torch.from_numpy((rng.standard_normal((b, 18, h, w)) * 2.0).astype(
        np.float32)).to(dev)
    mask = torch.from_numpy(rng.uniform(0.1, 1.0, (b, 9, h, w)).astype(
        np.float32)).to(dev)
    weight = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3))
                               / 24.0).astype(np.float32)).to(dev)
    bias = torch.zeros(cout, device=dev)
    cot = torch.from_numpy(rng.standard_normal((b, cout, h, w)).astype(
        np.float32)).to(dev)

    def grads():
        leaves = [t.clone().requires_grad_() for t in (x, off, mask, weight)]
        out = deform_conv.deform_conv2d(*leaves, bias)
        (out * cot).sum().backward()
        return [t.grad for t in leaves]

    kernels.reset_launch_counts()
    got = grads()
    counts = kernels.launch_counts()
    with kernels.force_plain():
        want = grads()
    for g, w, name in zip(got, want, ("x", "offsets", "mask", "weight")):
        assert g is not None and w is not None, name
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()),
                                   msg=name)
    assert counts["dcn_sample"] == 1 and counts["dcn_sample_bwd"] == 1


def test_kernel_wrappers_reject_bad_inputs():
    dev = _device()
    from tpuseg_torch.kernels.nms import nms_keep
    from tpuseg_torch.kernels.roi_align import multilevel_roi_align

    boxes = torch.zeros(1, 8, 4, device=dev)
    order = torch.arange(8, device=dev)[None]
    ok = torch.ones(1, 8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        nms_keep(boxes.double(), order, ok, 0.5)
    with pytest.raises(ValueError):  # the validity on the host
        nms_keep(boxes, order, ok.cpu(), 0.5)
    with pytest.raises(ValueError):  # an int32 order
        nms_keep(boxes, order.int(), ok, 0.5)
    with pytest.raises(ValueError):  # an order of another shape
        nms_keep(boxes, order[:, :7].contiguous(), ok, 0.5)
    feats = [torch.zeros(1, 8, 4, 4, device=dev)]  # NCHW, not channels_last
    with pytest.raises(ValueError):
        multilevel_roi_align(feats, torch.zeros(2, 4, device=dev),
                             torch.zeros(2, dtype=torch.int32, device=dev),
                             torch.zeros(2, dtype=torch.int32, device=dev),
                             7, 2, (4,))
    from tpuseg_torch.kernels.roi_align import multilevel_roi_align_backward

    with pytest.raises(ValueError):  # d(pooled) of the wrong shape
        multilevel_roi_align_backward(
            torch.zeros(2, 7, 7, 4, device=dev), torch.zeros(2, 4, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev), [(1, 8, 4, 4)],
            torch.float32, 7, 2, (4,))
    from tpuseg_torch.kernels.dcn import sample_points

    cl = torch.zeros(2, 8, 4, 4, device=dev).contiguous(
        memory_format=torch.channels_last)
    pts = torch.zeros(2, 5, device=dev)
    with pytest.raises(ValueError):  # NCHW, not channels_last
        sample_points(torch.zeros(2, 8, 4, 4, device=dev), pts, pts, pts)
    with pytest.raises(ValueError):  # f64 features
        sample_points(cl.double(), pts, pts, pts)
    with pytest.raises(ValueError):  # coordinates not f32
        sample_points(cl, pts.half(), pts, pts)
    with pytest.raises(ValueError):  # a batch other than the features'
        sample_points(cl, pts[:1], pts[:1], None)
    with pytest.raises(ValueError):  # modulation of another shape
        sample_points(cl, pts, pts, pts[:, :4].contiguous())
    with pytest.raises(ValueError):  # coordinates on the host
        sample_points(cl, pts.cpu(), pts, None)
    from tpuseg_torch.kernels.dcn import sample_points_backward

    g = torch.zeros(2, 5, 8, device=dev)
    with pytest.raises(ValueError):  # NCHW, not channels_last
        sample_points_backward(g, torch.zeros(2, 8, 4, 4, device=dev), pts,
                               pts, pts)
    with pytest.raises(ValueError):  # the gradient in another dtype
        sample_points_backward(g.bfloat16(), cl, pts, pts, pts)
    with pytest.raises(ValueError):  # the gradient of another shape
        sample_points_backward(g[:, :4].contiguous(), cl, pts, pts, pts)
    with pytest.raises(ValueError):  # the gradient not contiguous
        sample_points_backward(g.transpose(1, 2).contiguous().transpose(1, 2),
                               cl, pts, pts, pts)
    with pytest.raises(ValueError):  # modulation of another shape
        sample_points_backward(g, cl, pts, pts, pts[:, :4].contiguous())
