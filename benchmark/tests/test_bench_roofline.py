"""The roofline counts are ``chip_smoke.py``'s, the ones behind PERF.md's
kernel bounds, at the smoke's shapes (the RoIAlign at the training and
inference roi counts on the 800x1344 canvas, the DCN sampler at the
YOLACT++-550 geometries)."""
from __future__ import annotations

import pytest
import torch

import chip_smoke as S
from benchmark.common import roofline as R

CPU = torch.device("cpu")


@pytest.mark.parametrize("n,p", [(1024, 7), (256, 14), (2000, 7)])
def test_roi_align_bound_is_the_smokes(n, p):
    torch.manual_seed(0)
    case = S.roi_case(CPU, n)
    _, boxes, bidx, levels = case
    ours = R.roi_align_bound(S.LEVEL_HW, boxes, bidx, levels, p, 256, 4)
    assert ours * 1e3 == pytest.approx(S.roi_fwd_bound(case, p, 4)[0],
                                       rel=1e-12)


@pytest.mark.parametrize("shape", S.DCN_SHAPES[:3])
def test_dcn_bound_is_the_smokes(shape):
    feats, sy, sx, _ = S.dcn_case(CPU, *shape)
    ours = R.dcn_bound(tuple(feats.shape), feats.element_size(), sy, sx)
    assert ours * 1e3 == pytest.approx(S.dcn_bound(feats, sy, sx)[0],
                                       rel=1e-12)


def test_calls_bound_scales_the_kept_calls_to_all():
    calls = {"k": [{"t": 1.0}, {"t": 3.0}]}
    assert R.calls_bound(calls, {"k": 10}, "k", lambda c: c["t"]) == 20.0
    assert R.calls_bound({}, {}, "k", lambda c: 1.0) == 0.0


def test_no_kernel_time_gives_no_roofline():
    ctx = {"calls": {}, "counts": {}, "events": []}
    assert R.roofline_pct(ctx, [("roi_align", R.roi_call_bound)],
                          ("roi_align_kernel",)) is None
