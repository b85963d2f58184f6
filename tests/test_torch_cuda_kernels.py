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
from tpuseg_torch.ops import sampling

pytestmark = pytest.mark.cuda


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _boxes(rng, shape, extent=(200.0, 320.0)):
    xy = rng.uniform(0, 1, shape + (2,)) * np.array(extent[::-1]) * 0.8
    wh = rng.uniform(4, 80, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 819, 1000])
@pytest.mark.parametrize("to_remove", [0.0, 1.0])
def test_nms_kernel_matches_plain(n, to_remove):
    dev = _device()
    rng = np.random.default_rng(n)
    boxes = torch.from_numpy(_boxes(rng, (3, n))).to(dev)
    scores = torch.from_numpy(rng.uniform(size=(3, n)).round(2)
                              .astype(np.float32)).to(dev)
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


def test_kernel_wrappers_reject_bad_inputs():
    dev = _device()
    from tpuseg_torch.kernels.nms import nms_keep_sorted
    from tpuseg_torch.kernels.roi_align import multilevel_roi_align

    boxes = torch.zeros(1, 8, 4, device=dev)
    with pytest.raises(ValueError):
        nms_keep_sorted(boxes.double(), torch.ones(1, 8, dtype=torch.bool,
                                                   device=dev), 0.5)
    with pytest.raises(ValueError):
        nms_keep_sorted(boxes, torch.ones(1, 8, dtype=torch.bool), 0.5)
    feats = [torch.zeros(1, 8, 4, 4, device=dev)]  # NCHW, not channels_last
    with pytest.raises(ValueError):
        multilevel_roi_align(feats, torch.zeros(2, 4, device=dev),
                             torch.zeros(2, dtype=torch.int32, device=dev),
                             torch.zeros(2, dtype=torch.int32, device=dev),
                             7, 2, (4,))
