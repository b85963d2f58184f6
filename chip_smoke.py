#!/usr/bin/env python3
"""GPU smoke test of tpuseg_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (builds the kernels from tpuseg_torch/csrc).
Phases, one line each; any failure raises and exits non-zero:
  1. the card (nvidia-smi name and power limit);
  2. build of the CUDA kernels (each kernel's registers and spills from
     ptxas);
  3. the NMS kernel against its plain version at the main paths' shapes,
     at N = 2049 (one row block past 2048) and at the C4 budget N = 12 000
     (keep masks identical);
  4. the RoIAlign kernel against its plain version at the main paths'
     shapes (f32: atol = rtol = 1e-5; bf16: |err| <= 2^-8 |ref| + 1e-3, ref
     the plain version computed in f32 on the same bf16 inputs);
  5. the RoIAlign backward kernel against its plain version at the training
     step's shapes (f32: atol 1e-5 max|ref|, rtol 1e-5, since atomics add in
     an order that changes from run to run; bf16: |err| <= 2^-8 |ref| +
     1e-3 against the plain version in f32), and the differentiable
     pooler's feature gradient against the kernel's;
  6. the DCN sampling kernel against its plain version at the six DCN
     geometries of YOLACT++-550 R-50, B = 8, and at a ragged C (130, the
     kernel's narrow path): f32 and bf16 bit for bit, bf16 also as
     RoIAlign's against the plain version in f32; grid_sample against the
     plain version (1e-4 max|ref|), and a zero-offset DCN against F.conv2d
     (TF32 off, 1e-4);
  7. the DCN sampling backward kernel against its plain version at the
     same geometries, with the offsets of phase 6 and with zero offsets
     (every sample on an integer), f32 and bf16 (d feats as the RoIAlign
     backward's; d sy, d sx and d m rtol 1e-5 / atol 1e-6 max|ref|);
  8. Mask R-CNN R-50-FPN inference through MaskRCNNPredictor on the card
     (full width, 81 classes, synthetic upstream-keyed weights from a numpy
     seed): launch counts per forward, sane outputs, and the heads run on
     one shared pyramid through the kernels and through the plain versions
     must agree detection for detection;
  9. Mask R-CNN R-50-FPN training through do_train: 3 iterations at B = 2
     on the 800x1344 canvas over an in-memory synthetic dataset, launch
     counts per step, finite losses, frozen stages still and the rest
     moved; then one step on one batch with the same draws and TF32 off,
     through the kernels and through the plain versions (losses rtol 1e-6,
     gradients rtol 1e-4 / atol 1e-6 max|g|);
  10. YOLACT++-550 R-50-FPN inference through YolactPredictor on the card
     (full width, synthetic upstream-keyed weights with non-zero DCN
     offsets), f32 and bf16 at B = 1 and 8: 13 DCN sampling launches per
     forward, sane detections, and kernels vs plain detection for
     detection, also with greedy NMS (use_fast_nms=False, one NMS launch);
  11. YOLACT++-550 R-50-FPN training through yolact_train_loop.train: 3
     iterations at B = 8 in f32 (TF32 convolutions, train-mode BatchNorm)
     over an in-memory synthetic dataset of 480-640 px images with 5-15
     elliptic masks each: 13 dcn_sample and 13 dcn_sample_bwd launches per
     step, finite B/C/M/S/I, every parameter moved, every running
     statistic updated, the checkpoint loads; then one step on one batch
     with the same draws and TF32 off through the kernels and through the
     plain versions (as phase 9);
  12. timings: each kernel against its plain version and its bound (DCN
     sampling also against grid_sample, its backward against
     grid_sample's; NMS also the kernel launch alone, without the sort
     around it), Mask R-CNN forward img/s at B = 1 and 2 and its
     training step at B = 2 on the 800x1344 canvas, YOLACT++ forward and
     run_batch img/s at B = 1 and 8 in f32 and bf16, and its training step
     at B = 8, through both paths, with the host's batch time apart.
Then the smoke's seconds, one JSON line of kernel results, the nvidia-smi
line, and as the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch import kernels
from tpuseg_torch.configs.presets import (yolact_loss_config,
                                          yolact_model_config)
from tpuseg_torch.engine import detectron_train_loop as TL
from tpuseg_torch.engine import yolact_train_loop as YTL
from tpuseg_torch.engine.maskrcnn_engine import (MaskRCNNPredictor,
                                                 preprocess_image_bgr)
from tpuseg_torch.engine.trainer import (ckpt_path, make_optimizer,
                                         make_yolact_optimizer,
                                         yolact_lr_schedule)
from tpuseg_torch.engine.yolact_engine import YolactPredictor
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import yolact as YM
from tpuseg_torch.models import yolact_loss as YLOSS
from tpuseg_torch.nn.layers import FrozenBatchNorm2d
from tpuseg_torch.ops import nms as nms_ops
from tpuseg_torch.ops import sampling
from tpuseg_torch.ops.deform_conv import dcn_sample_coords, deform_conv2d
from tpuseg_torch.ops.preprocess import yolact_preprocess

SEED = 0
CANVAS = (800, 1344)
LEVEL_HW = [(200, 336), (100, 168), (50, 84), (25, 42)]
STRIDES = (4, 8, 16, 32)
# cls_score weights N(0, 1/fan) times this: a few hundred class-box
# candidates pass score_thresh = 0.05 (so the final NMS has real work), fewer
# than the 2048 slots (so the candidate cut is not decided by near-ties), and
# no softmax score saturates at 1.0 (272 candidates at a 320x480 canvas)
CLS_SCORE_SCALE = 0.008
TRAIN_STEPS = 3
PER_STEP = {"nms": 5, "roi_align": 2, "roi_align_bwd": 2,
            "dcn_sample": 0, "dcn_sample_bwd": 0}
# the backward's shapes at B = 2: the box pooler's 2 x 512 sampled rois at
# P = 7 and the mask pooler's 2 x 128 at P = 14
BWD_SHAPES = ((1024, 7), (256, 14))
PIXEL_VAR = 75.0 ** 2  # of textured_image's pixels less the pixel mean
# DCN offset convs' weights: N(0, 1/fan) times this, so the offsets have a
# standard deviation of 1.5-3.5 px (see synthetic_yolact_state_dict)
OFFSET_SCALE = 2.0
# the DCN offset convs of the training phase: offsets of ~0.2-0.4 px, off
# the integers; at OFFSET_SCALE the first SGD step at upstream's warm-up lr
# blows the losses up (B = 8 at 550: total 203, 17357, 4.9e7 in three
# steps), since a random offset field of a few pixels is no state that
# training from upstream's zero offsets passes through (measured on an H100)
TRAIN_OFFSET_SCALE = 0.2
# YOLACT's class-logit layer: N(0, 1/fan) times this spreads the best
# class scores, so that few of them lie near the 0.05 gate
CONF_SCALE = 3.0
# the least time of a kernel's work: bytes over the H100 SXM's memory rate,
# f32 operations over its rate outside the tensor cores (the H100 SXM's
# published peaks; the kernels compute in f32 for bf16 data too)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
NMS_OPS_PER_PAIR = 16  # the IoU: 2 min, 2 max, 4 sub/add, 2 clamp, mul,
#                        add, sub, clamp, div; the threshold compare
ROI_OPS_PER_SAMPLE = 12  # per channel: 4 corner weights, 4 mul, 4 add
# YOLACT++-550 R-50's deformable 3x3 convs, (H, W, C, stride) of their
# inputs: layer2 block 0, blocks 1-3, layer3 block 0, blocks 1-5, layer4
# block 0, blocks 1-2 (13 per forward)
DCN_SHAPES = ((138, 138, 128, 2), (69, 69, 128, 1), (69, 69, 256, 2),
              (35, 35, 256, 1), (35, 35, 512, 2), (18, 18, 512, 1))
DCN_PER_FORWARD = (1, 3, 1, 5, 1, 2)
# a channel count that no 16-byte vector divides (the kernel's narrow path)
DCN_RAGGED = (69, 69, 130, 1)
DCN_BATCH = 8
DCN_OPS_PER_VALUE = 12  # per sample and channel: 4 corner weights, 4 mul,
#                         3 add, the modulation
DCN_BWD_OPS_PER_VALUE = 36  # per sample and channel: g * m, 4 corner
# weights times it and 4 adds into d feats; 3 x (4 mul + 3 add) for the
# d sy, d sx and d m terms; 3 mul + 3 add into their sums
YOLACT_TRAIN_STEPS = 3
YOLACT_BATCH = 8
YOLACT_PER_STEP = {"nms": 0, "roi_align": 0, "roi_align_bwd": 0,
                   "dcn_sample": sum(DCN_PER_FORWARD),
                   "dcn_sample_bwd": sum(DCN_PER_FORWARD)}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn()`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def random_boxes(g: torch.Generator, shape, dev, extent=CANVAS, clusters=40):
    """Boxes [..., 4] in clusters (so NMS has real work) over the canvas,
    side lengths log-uniform in [8, 512] px."""
    n = int(np.prod(shape))
    cy = torch.rand(clusters, generator=g) * extent[0]
    cx = torch.rand(clusters, generator=g) * extent[1]
    k = torch.randint(0, clusters, (n,), generator=g)
    yc = cy[k] + torch.randn(n, generator=g) * 12.0
    xc = cx[k] + torch.randn(n, generator=g) * 12.0
    h = torch.exp(torch.empty(n).uniform_(np.log(8), np.log(512), generator=g))
    w = h * torch.exp(torch.randn(n, generator=g) * 0.5)
    b = torch.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], 1)
    b[:, 0::2] = b[:, 0::2].clamp(0, extent[1] - 1)
    b[:, 1::2] = b[:, 1::2].clamp(0, extent[0] - 1)
    return b.reshape(*shape, 4).to(dev)


# ---------------------------------------------------------------------------
# phase 3: NMS
# ---------------------------------------------------------------------------


def nms_cases(dev):
    """(label, boxes, scores, valid, classes or None, thr) at the main paths'
    shapes: B = 2; N = 819 (P6), 1000 (RPN levels at inference), 2000 (RPN
    levels in training), 2048 (final, class-aware); also N = 2049 (one row
    block past 2048) and 12 000 (Mask R-CNN C4's training RPN budget)."""
    g = torch.Generator().manual_seed(SEED + 3)
    cases = []
    for n, thr in ((819, 0.7), (1000, 0.7), (2000, 0.7), (2048, 0.5),
                   (2049, 0.7), (12000, 0.7)):
        boxes = random_boxes(g, (2, n), dev)
        scores = torch.rand(2, n, generator=g).to(dev)
        valid = (torch.rand(2, n, generator=g) < 0.9).to(dev)
        cases.append((f"N={n} thr={thr}", boxes, scores, valid, None, thr))
    # duplicates with tied scores, and an all-invalid image
    boxes = random_boxes(g, (2, 1000), dev)
    boxes[0, 100:300] = boxes[0, 50]
    scores = (torch.rand(2, 1000, generator=g) * 10).round().div(10).to(dev)
    valid = torch.ones(2, 1000, dtype=torch.bool, device=dev)
    valid[1] = False
    cases.append(("duplicates, ties, all-invalid image", boxes, scores, valid,
                  None, 0.7))
    # class-aware final NMS through the coordinate offset, 80 classes
    boxes = random_boxes(g, (2, 2048), dev)
    scores = torch.rand(2, 2048, generator=g).to(dev)
    valid = (torch.rand(2, 2048, generator=g) < 0.8).to(dev)
    classes = torch.randint(0, 80, (2, 2048), generator=g).to(dev)
    cases.append(("class-aware N=2048", boxes, scores, valid, classes, 0.5))
    return cases


def run_nms(boxes, scores, valid, classes, thr):
    if classes is None:
        return nms_ops.nms_mask_batch(boxes, scores, thr, valid, to_remove=1.0)
    return nms_ops.batched_nms_mask_batch(boxes, scores, classes, thr, valid,
                                          to_remove=1.0)


def phase_nms(dev) -> dict:
    lines, worst = [], 0.0
    for label, boxes, scores, valid, classes, thr in nms_cases(dev):
        got = run_nms(boxes, scores, valid, classes, thr)
        with kernels.force_plain():
            want = run_nms(boxes, scores, valid, classes, thr)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"NMS {label}: {bad} keep bits differ")
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        lines.append(f"{label}: {int(got.sum())}/{int(valid.sum())} kept")
    log("[3 nms] keep masks identical to the plain version: "
        + "; ".join(lines))
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 4: RoIAlign
# ---------------------------------------------------------------------------


def roi_case(dev, n: int, dtype=torch.float32):
    g = torch.Generator().manual_seed(SEED + 4 + n)
    feats = [torch.randn(2, 256, h, w, generator=g).to(dev, dtype)
             .contiguous(memory_format=torch.channels_last) for h, w in LEVEL_HW]
    boxes = random_boxes(g, (n,), dev)
    bidx = torch.randint(0, 2, (n,), generator=g).to(dev)
    levels = sampling.clamp_levels_to_window(feats, boxes,
                                             M.assign_levels(boxes), STRIDES)
    return feats, boxes, bidx, levels


def run_roi(case, p):
    feats, boxes, bidx, levels = case
    return sampling.multilevel_roi_align(feats, boxes, bidx, levels, p, 2,
                                         STRIDES)


def phase_roi_align(dev) -> dict:
    worst = 0.0
    lines = []
    for n, p in ((2000, 7), (200, 14)):
        case = roi_case(dev, n)
        got = run_roi(case, p)
        with kernels.force_plain():
            want = run_roi(case, p)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        # bf16: the reference is the plain version computed in f32 on the
        # same bf16 inputs, so the kernel's only error is the rounding of
        # its output to bf16 (half an ulp, <= 2^-8 |ref|) plus sum order
        case_bf = roi_case(dev, n, torch.bfloat16)
        got_bf = run_roi(case_bf, p).float()
        feats_bf, boxes, bidx, levels = case_bf
        with kernels.force_plain():
            want_bf = run_roi(([f.float() for f in feats_bf], boxes, bidx,
                               levels), p)
        err_bf = (got_bf - want_bf).abs()
        with kernels.force_plain():
            plain_bf = run_roi(case_bf, p).float()
        err_bf_plain = float((got_bf - plain_bf).abs().max())
        excess = float((err_bf - (2.0 ** -8 * want_bf.abs() + 1e-3)).max())
        if excess > 0:
            raise AssertionError(f"RoIAlign bf16 N={n} P={p}: error exceeds "
                                 f"2^-8|ref| + 1e-3 by {excess}")
        levels = torch.bincount(case[3].long(), minlength=4).tolist()
        lines.append(f"N={n} P={p} levels {levels}: f32 max err {err:.3g}; "
                     f"bf16 max err {float(err_bf.max()):.3g} vs the f32 "
                     f"plain, {err_bf_plain:.3g} vs the bf16 plain")
    log("[4 roi_align] within tolerance of the plain version: "
        + "; ".join(lines))
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 5: RoIAlign backward
# ---------------------------------------------------------------------------


def bwd_case(dev, n: int, p: int, dtype=torch.float32):
    """(d(pooled) [N, 256, P, P], boxes, batch_idx, levels, level shapes)."""
    g = torch.Generator().manual_seed(SEED + 5 + n)
    shapes = [(2, 256, h, w) for h, w in LEVEL_HW]
    boxes = random_boxes(g, (n,), dev)
    bidx = torch.randint(0, 2, (n,), generator=g).to(dev)
    probe = [torch.empty(sh, dtype=dtype, device="meta") for sh in shapes]
    levels = sampling.clamp_levels_to_window(probe, boxes,
                                             M.assign_levels(boxes), STRIDES)
    grad = torch.randn(n, 256, p, p, generator=g).to(dev, dtype)
    return grad, boxes, bidx, levels, shapes


def run_bwd(case, p: int, dtype):
    grad, boxes, bidx, levels, shapes = case
    return sampling.multilevel_roi_align_backward(grad, boxes, bidx, levels,
                                                  shapes, dtype, p, 2, STRIDES)


def bwd_error(got, want, dtype, label: str) -> float:
    """Max |got - want| over the levels; raises past the tolerance. f32:
    atomics add in an order that changes from run to run, so the kernel
    meets the plain backward to rounding: atol 1e-5 max|ref| (per level),
    rtol 1e-5. bf16 features: ``want`` is the plain backward in f32, and
    the kernel's f32 sum is rounded once to bf16: 2^-8 |ref| + 1e-3."""
    worst = 0.0
    for lv, (a, w) in enumerate(zip(got, want)):
        if a.shape != w.shape or a.dtype != dtype:
            raise AssertionError(f"{label} level {lv}: {a.dtype} "
                                 f"{tuple(a.shape)}, want {dtype} "
                                 f"{tuple(w.shape)}")
        err = (a.float() - w).abs()
        if dtype == torch.float32:
            tol = 1e-5 * w.abs() + 1e-5 * float(w.abs().max())
        else:
            tol = 2.0 ** -8 * w.abs() + 1e-3
        excess = float((err - tol).max())
        if excess > 0:
            raise AssertionError(f"{label} level {lv}: error exceeds the "
                                 f"tolerance by {excess}")
        worst = max(worst, float(err.max()))
    return worst


def phase_roi_align_bwd(dev) -> dict:
    worst, lines = 0.0, []
    for n, p in BWD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            case = bwd_case(dev, n, p, dt)
            got = run_bwd(case, p, dt)
            grad, boxes, bidx, levels, shapes = case
            with kernels.force_plain():
                want = sampling.multilevel_roi_align_backward(
                    grad.float(), boxes, bidx, levels, shapes, torch.float32,
                    p, 2, STRIDES)
            err = bwd_error(got, want, dt, f"N={n} P={p} {dt}")
            if dt == torch.float32:
                worst = max(worst, err)
            lines.append(f"N={n} P={p} {str(dt)[6:]} max err {err:.3g}")
    # the differentiable pooler on channels-last levels that need grad:
    # one forward and one backward launch, and .grad equal to the kernel's
    # output for the same d(pooled)
    case = bwd_case(dev, *BWD_SHAPES[0])
    grad, boxes, bidx, levels, shapes = case
    g = torch.Generator().manual_seed(SEED + 6)
    feats = [torch.randn(sh, generator=g).to(dev)
             .contiguous(memory_format=torch.channels_last).requires_grad_()
             for sh in shapes]
    kernels.reset_launch_counts()
    out = sampling.multilevel_roi_align(feats, boxes, bidx, levels,
                                        BWD_SHAPES[0][1], 2, STRIDES)
    out.backward(grad)
    counts = kernels.launch_counts()
    if counts != {"nms": 0, "roi_align": 1, "roi_align_bwd": 1,
                  "dcn_sample": 0, "dcn_sample_bwd": 0}:
        raise AssertionError(f"pooler forward + backward launched {counts}")
    err = bwd_error([f.grad for f in feats],
                    run_bwd(case, BWD_SHAPES[0][1], torch.float32),
                    torch.float32, "autograd .grad vs the kernel")
    log("[5 roi_align_bwd] within tolerance of the plain backward: "
        + "; ".join(lines) + f"; the pooler's autograd .grad (channels-last "
        f"leaves) vs the kernel's output: max err {err:.3g}")
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 6: DCN sampling
# ---------------------------------------------------------------------------


def dcn_case(dev, h: int, w: int, c: int, stride: int, dtype=torch.float32,
             zero: bool = False):
    """Features [B, C, H, W] (channels-last) and the points that
    deform_conv2d samples on them: offsets ~ N(0, 2^2) px, 1 % of them
    pushed 8-25 px further out (or, with ``zero``, no offsets: every sample
    on an integer), modulation sigmoid(N(0, 1))."""
    g = torch.Generator().manual_seed(SEED + 10 + h + c + stride)
    b = DCN_BATCH
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    feats = torch.randn(b, c, h, w, generator=g).to(dev, dtype).contiguous(
        memory_format=torch.channels_last)
    off = torch.randn(b, 18, ho, wo, generator=g) * 2.0
    far = torch.rand(off.shape, generator=g) < 0.01
    n = int(far.sum())
    off[far] += (8.0 + 17.0 * torch.rand(n, generator=g)) * torch.sign(
        torch.randn(n, generator=g))
    if zero:
        off.zero_()
    mask = torch.sigmoid(torch.randn(b, 9, ho, wo, generator=g))
    return (feats, *dcn_sample_coords(off.to(dev), mask.to(dev), 3, stride,
                                      1, 1))


def grid_sample_points(feats, sy, sx, m):
    """The sampler's function as one PyTorch call (the yardstick for
    library_ms; nothing on the port's path calls it): grid_sample with
    align_corners=True maps -1 and 1 to the first and last pixel centres,
    zero padding, then the modulation. grid_sample takes its grid in the
    features' dtype, so for bf16 features the points are rounded to bf16."""
    h, w = feats.shape[2:]
    grid = torch.stack([2.0 * sx / (w - 1) - 1.0, 2.0 * sy / (h - 1) - 1.0],
                       -1)[:, :, None, :]
    out = F.grid_sample(feats, grid.to(feats.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[..., 0].transpose(1, 2) * m[..., None].to(feats.dtype)


def phase_dcn(dev) -> dict:
    """At each DCN geometry of YOLACT++-550 R-50 and at DCN_RAGGED, B = 8:
    f32 and bf16 equal to the plain version bit for bit; bf16 also within
    2^-8 |ref| + 1e-3 of the plain version in f32; grid_sample within 1e-4
    max|ref| of the plain version; a DCN with zero offsets and unit
    modulation equal to F.conv2d (TF32 off) within rtol 1e-4 / atol 1e-4
    max|ref|."""
    worst, lines = 0.0, []
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for h, w, c, st in DCN_SHAPES + (DCN_RAGGED,):
            feats, sy, sx, m = dcn_case(dev, h, w, c, st)
            got = sampling.sample_points(feats, sy, sx, m)
            want = sampling.sample_points_plain(feats, sy, sx, m)
            worst = max(worst, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"dcn_sample {h}x{w}x{c}: f32 differs "
                                     f"from the plain version by "
                                     f"{float((got - want).abs().max())}")
            fb = feats.bfloat16()
            got_bf = sampling.sample_points(fb, sy, sx, m)
            if not torch.equal(got_bf, sampling.sample_points_plain(fb, sy, sx,
                                                                    m)):
                raise AssertionError(f"dcn_sample {h}x{w}x{c}: bf16 differs "
                                     "from the plain version")
            got_bf = got_bf.float()
            ref = sampling.sample_points_plain(fb.float(), sy, sx, m)
            err_bf = (got_bf - ref).abs()
            excess = float((err_bf - (2.0 ** -8 * ref.abs() + 1e-3)).max())
            if excess > 0:
                raise AssertionError(f"dcn_sample bf16 {h}x{w}x{c}: error "
                                     f"exceeds 2^-8|ref| + 1e-3 by {excess}")
            lib_err = float((grid_sample_points(feats, sy, sx, m)
                             - want).abs().max())
            # grid_sample carries each point through [-1, 1] and back:
            # ~(W - 1) 2^-24 px of rounding, 5e-5 of max|ref| at 138 px
            if lib_err > 1e-4 * float(want.abs().max()):
                raise AssertionError(f"grid_sample {h}x{w}x{c}: {lib_err}")
            wt = torch.randn(c, c, 3, 3, device=dev) * (9 * c) ** -0.5
            bias = torch.randn(c, device=dev) * 0.1
            ho, wo = (h - 1) // st + 1, (w - 1) // st + 1
            dcn = deform_conv2d(feats, torch.zeros(DCN_BATCH, 18, ho, wo,
                                                   device=dev),
                                torch.ones(DCN_BATCH, 9, ho, wo, device=dev),
                                wt, bias, 3, st, 1, 1)
            conv = F.conv2d(feats, wt, bias, stride=st, padding=1)
            conv_err = float((dcn - conv).abs().max())
            torch.testing.assert_close(dcn, conv, rtol=1e-4,
                                       atol=1e-4 * float(conv.abs().max()))
            outside = float((want[:, :, 0] == 0).float().mean())
            lines.append(f"{h}x{w}x{c} s{st}: f32 and bf16 equal, bf16 vs "
                         f"the f32 plain max err "
                         f"{float(err_bf.max()):.3g}, grid_sample "
                         f"{lib_err:.3g}, zero-offset DCN vs conv "
                         f"{conv_err:.3g}, {100 * outside:.1f} % of samples "
                         f"wholly outside")
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    log(f"[6 dcn_sample] B = {DCN_BATCH}: " + "; ".join(lines))
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 7: DCN sampling backward
# ---------------------------------------------------------------------------


def dcn_grad(dev, feats, sy) -> torch.Tensor:
    """A gradient of the sampled values [B, S, C] ~ N(0, 1), in the feature
    dtype."""
    g = torch.Generator().manual_seed(SEED + 20 + feats.shape[1])
    return torch.randn(feats.shape[0], sy.shape[1], feats.shape[1],
                       generator=g).to(dev, feats.dtype)


def run_dcn_bwd(grad, feats, sy, sx, m) -> tuple:
    return sampling.sample_points_backward(grad, feats, sy, sx, m)


def dcn_bwd_error(got, want, dtype, label: str) -> float:
    """Max |got - want| over d feats, d sy, d sx, d m; raises past the
    tolerance. d feats: f32 atol 1e-5 max|ref| / rtol 1e-5 (atomics add in
    an order that changes from run to run); bf16 features: ``want`` is the
    plain backward in f32 and the kernel's f32 sum is rounded once to
    bf16, 2^-8 |ref| + 1e-3. d sy, d sx, d m (f32 for either dtype): rtol
    1e-5 / atol 1e-6 max|ref| (the warp sums the channels in another
    order)."""
    worst = 0.0
    for i, (a, w) in enumerate(zip(got, want)):
        want_dt = dtype if i == 0 else torch.float32
        if a.shape != w.shape or a.dtype != want_dt:
            raise AssertionError(f"{label} output {i}: {a.dtype} "
                                 f"{tuple(a.shape)}, want {want_dt} "
                                 f"{tuple(w.shape)}")
        err = (a.float() - w).abs()
        scale = float(w.abs().max())
        if i == 0 and dtype == torch.bfloat16:
            tol = 2.0 ** -8 * w.abs() + 1e-3
        elif i == 0:
            tol = 1e-5 * w.abs() + 1e-5 * scale
        else:
            tol = 1e-5 * w.abs() + 1e-6 * scale
        excess = float((err - tol).max())
        if excess > 0:
            raise AssertionError(f"{label} output {i}: error exceeds the "
                                 f"tolerance by {excess}")
        worst = max(worst, float(err.max()))
    return worst


def phase_dcn_bwd(dev) -> dict:
    """At each DCN geometry of YOLACT++-550 R-50, B = 8, with phase 6's
    offsets and with none: the backward kernel against its plain version
    (computed in f32 on the same values), f32 and bf16."""
    worst, lines = 0.0, []
    for h, w, c, st in DCN_SHAPES:
        errs = []
        for zero in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                feats, sy, sx, m = dcn_case(dev, h, w, c, st, dt, zero)
                grad = dcn_grad(dev, feats, sy)
                got = run_dcn_bwd(grad, feats, sy, sx, m)
                with kernels.force_plain():
                    want = run_dcn_bwd(grad.float(), feats.float(), sy, sx, m)
                label = (f"dcn_sample_bwd {h}x{w}x{c} s{st} {str(dt)[6:]}"
                         + (" zero offsets" if zero else ""))
                err = dcn_bwd_error(got, want, dt, label)
                if dt == torch.float32:
                    worst = max(worst, err)
                errs.append(f"{err:.3g}")
        lines.append(f"{h}x{w}x{c} s{st}: max err f32 {errs[0]}, bf16 "
                     f"{errs[1]}, zero offsets f32 {errs[2]}, bf16 {errs[3]}")
    torch.cuda.synchronize()
    log(f"[7 dcn_sample_bwd] B = {DCN_BATCH}, within tolerance of the plain "
        "backward: " + "; ".join(lines))
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 8: Mask R-CNN inference
# ---------------------------------------------------------------------------


def synthetic_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Upstream-keyed random weights from a numpy seed (the scheme of
    tests/test_cross_parity.py::_synth_state): FrozenBN stats near 1,
    weights N(0, 1/fan), small biases, tame RPN outputs (no saturated
    objectness or clipped deltas)."""
    rng = np.random.default_rng(seed)
    special = {"rpn.head.cls_logits.weight": 3e-4,
               "rpn.head.bbox_pred.weight": 1e-4}
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("running_var") or (k.endswith(".weight") and len(shape) == 1):
            a = rng.uniform(0.7, 1.3, shape)
        elif k in special:
            a = rng.standard_normal(shape) * special[k]
        elif k.endswith(".weight"):
            a = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
            if k == "roi_heads.box.predictor.cls_score.weight":
                a *= CLS_SCORE_SCALE
            elif k == "roi_heads.box.predictor.bbox_pred.weight":
                a *= 0.05
        elif k.endswith("running_mean"):
            a = rng.standard_normal(shape) * 0.05
        else:  # biases
            a = rng.standard_normal(shape) * 0.02
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def textured_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """[h, w, 3] uint8: smooth random blobs plus noise, so the backbone sees
    structure."""
    low = rng.uniform(0, 255, (h // 40 + 1, w // 40 + 1, 3))
    img = np.kron(low, np.ones((40, 40, 1)))[:h, :w]
    img += rng.normal(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def synthetic_images(seed: int):
    """Two landscape 800x1200 and one portrait 1200x800 BGR images."""
    rng = np.random.default_rng(seed)
    return ([textured_image(rng, 800, 1200), textured_image(rng, 800, 1200)],
            textured_image(rng, 1200, 800))


def check_result(res: dict, h: int, w: int) -> int:
    n = len(res["scores"])
    assert res["boxes"].shape == (n, 4) and res["classes"].shape == (n,)
    assert res["masks"].shape == (n, h, w) and res["masks"].dtype == np.uint8
    assert np.isfinite(res["boxes"]).all() and np.isfinite(res["scores"]).all()
    assert ((res["scores"] > 0) & (res["scores"] <= 1)).all()
    assert (res["boxes"][:, 0::2] <= w - 1).all()
    assert (res["boxes"][:, 1::2] <= h - 1).all()
    assert ((res["classes"] >= 0) & (res["classes"] < 80)).all()
    return n


def compare_heads(got: dict, want: dict) -> str:
    """Kernel path vs plain path on one pyramid: detection for detection."""
    lines = []
    for i in range(got["valid"].shape[0]):
        gv, wv = got["valid"][i], want["valid"][i]
        if int(gv.sum()) != int(wv.sum()):
            raise AssertionError(f"image {i}: {int(gv.sum())} vs "
                                 f"{int(wv.sum())} detections")
        if not torch.equal(got["classes"][i][gv], want["classes"][i][wv]):
            raise AssertionError(f"image {i}: classes differ")
        torch.testing.assert_close(got["boxes"][i][gv], want["boxes"][i][wv],
                                   atol=1e-3, rtol=0)
        torch.testing.assert_close(got["scores"][i][gv], want["scores"][i][wv],
                                   atol=0, rtol=1e-5)
        torch.testing.assert_close(got["masks"][i][gv], want["masks"][i][wv],
                                   atol=1e-4, rtol=0)
        err = {k: float((got[k][i][gv] - want[k][i][wv]).abs().max())
               for k in ("boxes", "scores", "masks")}
        lines.append(f"image {i}: {int(gv.sum())} dets, max err boxes "
                     f"{err['boxes']:.3g} scores {err['scores']:.3g} masks "
                     f"{err['masks']:.3g}")
    return "; ".join(lines)


def phase_slice(dev, tmp: Path) -> tuple:
    cfg = M.MaskRCNNConfig()
    ckpt = tmp / "synthetic_e2e_mask_rcnn_R_50_FPN.pth"
    torch.save({"model": synthetic_state_dict(M.build_model(cfg), SEED)}, ckpt)
    pred = MaskRCNNPredictor(cfg, weights=str(ckpt), device=dev)
    landscape, portrait = synthetic_images(SEED)

    kernels.reset_launch_counts()
    res_l = pred.run_on_bgr_images(landscape)
    after_l = kernels.launch_counts()
    res_p = pred.run_on_bgr_image(portrait)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    per_forward = {"nms": 6, "roi_align": 2, "roi_align_bwd": 0,
                   "dcn_sample": 0, "dcn_sample_bwd": 0}
    if after_l != per_forward or counts != {k: 2 * v for k, v in per_forward.items()}:
        raise AssertionError(f"launches: {after_l} after the landscape batch, "
                             f"{counts} after the portrait image; want "
                             f"{per_forward} per forward")
    ndet = [check_result(r, *img.shape[:2])
            for r, img in zip(res_l + [res_p], landscape + [portrait])]
    if min(ndet) == 0:
        raise AssertionError(f"no detections: {ndet}")
    log(f"[8 inference] predictor on 2 landscape 800x1200 + 1 portrait 1200x800 "
        f"images: launches {counts} (6 NMS + 2 RoIAlign per forward), "
        f"detections {ndet}")

    # heads on one pyramid, kernels vs plain; TF32 off for the heads so the
    # comparison sees the kernels' differences only
    images, image_hw = canvas_batch(pred, landscape)
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            pyramid = pred.model.backbone(images)
            got = M.forward_heads(pred.model, pyramid, image_hw, CANVAS)
            with kernels.force_plain():
                want = M.forward_heads(pred.model, pyramid, image_hw, CANVAS)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    log(f"[8 inference] heads on one pyramid, kernels vs plain: "
        f"{compare_heads(got, want)}; valid proposals "
        f"{got['proposal_valid'].sum(1).tolist()}, class-box candidates "
        f"{got['candidate_valid'].sum(1).tolist()}")
    return pred, counts


def canvas_batch(pred: MaskRCNNPredictor, imgs: list):
    canv, hws = [], []
    for img in imgs:
        c, hw, _ = preprocess_image_bgr(img)
        canv.append(c)
        hws.append(hw)
    images = torch.from_numpy(np.stack(canv).transpose(0, 3, 1, 2).copy())
    return (images.to(pred.device),
            torch.tensor(hws, dtype=torch.int64, device=pred.device))


# ---------------------------------------------------------------------------
# phase 9: Mask R-CNN training
# ---------------------------------------------------------------------------


def elliptic_instances(rng: np.random.Generator, img: np.ndarray,
                       n_gt: int) -> tuple:
    """(img, target): ``n_gt`` boxes of 4-33 % of the image's sides, each
    with an elliptic mask inside it painted into ``img`` in a colour of its
    own, classes 0..79, no crowd."""
    h, w = img.shape[:2]
    yy, xx = np.mgrid[:h, :w]
    wh = rng.uniform(0.04, 0.33, (n_gt, 2)) * [w, h]
    xy = rng.uniform(0, 1, (n_gt, 2)) * ([w, h] - wh)
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    masks = np.zeros((n_gt, h, w), np.uint8)
    for j, (x1, y1, x2, y2) in enumerate(boxes):
        cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
        masks[j] = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
        img[masks[j] > 0] = rng.integers(0, 256, 3)
    return img, {"boxes": boxes,
                 "classes": rng.integers(0, 80, n_gt).astype(np.int64),
                 "masks": masks, "iscrowd": np.zeros(n_gt, np.int64)}


class SyntheticDataset:
    """In memory, with the interface do_train reads (that of the JAX
    package's CocoDetectionDataset): landscape 800x1200 RGB images, so the
    800x1344 canvas takes them without a resize, each with ``n_gt`` gt
    boxes, elliptic blob masks inside them painted into the image, and
    classes 0..79."""

    def __init__(self, seed: int, n_images: int = 4, n_gt: int = 10,
                 h: int = 800, w: int = 1200):
        rng = np.random.default_rng(seed)
        self.image_ids = list(range(1, n_images + 1))
        self.coco = SimpleNamespace(
            imgs={i: {"width": w, "height": h} for i in self.image_ids})
        self._data = {}
        for i in self.image_ids:
            self._data[i] = elliptic_instances(rng, textured_image(rng, h, w),
                                               n_gt)

    def load_image(self, iid) -> np.ndarray:
        return self._data[iid][0].copy()

    def load_target(self, iid) -> dict:
        return {k: v.copy() for k, v in self._data[iid][1].items()}


class SyntheticYolactDataset(SyntheticDataset):
    """In memory, with the interface yolact_train_loop.train reads:
    textured RGB images of 480-640 px a side (height and width drawn
    apart), each with 5-15 elliptic masks painted in."""

    def __init__(self, seed: int, n_images: int = YOLACT_BATCH):
        rng = np.random.default_rng(seed)
        self.image_ids = list(range(1, n_images + 1))
        self._data = {}
        for i in self.image_ids:
            h, w = (int(v) for v in rng.integers(480, 641, 2))
            self._data[i] = elliptic_instances(
                rng, textured_image(rng, h, w), int(rng.integers(5, 16)))


def frozen_names(model) -> list:
    """State-dict keys that must not train: the stem and layer1
    (FREEZE_CONV_BODY_AT 2) and every FrozenBN buffer."""
    names = [k for k in model.state_dict()
             if k.startswith(("backbone.body.stem.", "backbone.body.layer1."))]
    for m_name, m in model.named_modules():
        if isinstance(m, FrozenBatchNorm2d):
            names += [f"{m_name}.{b}" for b, _ in m.named_buffers()]
    return sorted(set(names))


def step_grads(model, images, image_hw, targets, seed: int) -> tuple:
    """Losses and parameter gradients of one training forward + backward,
    the samplers drawing from a generator seeded with ``seed``."""
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=images.device).manual_seed(seed)
    losses = M.forward_train_losses(model, images, image_hw, targets,
                                    generator=gen)
    losses["total"].backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def compare_steps(got: tuple, want: tuple, atol: float = 1e-6,
                  split: str | None = None) -> str:
    """Kernel path vs plain path of one step: losses rtol 1e-6 (the forward
    is the same: the forward kernels equal their plain versions bit for
    bit), every gradient rtol 1e-4 / atol ``atol`` max|g| (the backward
    kernels add with atomics, in an order that changes from run to run, as
    does the plain versions' index_add_ on the card). A failure names the
    three gradients furthest past the tolerance. With ``split``, the
    largest error of the gradients whose name holds it is reported apart
    from the rest's."""
    (gl, gg), (wl, wg) = got, want
    for k, w in wl.items():
        if not abs(gl[k] - w) <= 1e-6 * abs(w):
            raise AssertionError(f"loss {k}: kernels {gl[k]!r}, plain {w!r}")
    if sorted(gg) != sorted(wg):
        raise AssertionError("the two paths give gradients to other parameters")
    worst, zero, bad = {True: 0.0, False: 0.0}, [], []
    for name, w in wg.items():
        scale = float(w.abs().max())
        if scale == 0.0:
            zero.append(name)
            if bool(gg[name].abs().max() > 0):
                raise AssertionError(f"{name}: plain gradient 0, kernels not")
            continue
        err = (gg[name] - w).abs()
        excess = float((err - (1e-4 * w.abs() + atol * scale)).max())
        if excess > 0:
            bad.append((excess / scale, name, float(err.max()) / scale))
        apart = split is not None and split in name
        worst[apart] = max(worst[apart], float(err.max()) / scale)
    if bad:
        raise AssertionError(
            f"gradients past rtol 1e-4 / atol {atol:g} max|g| (excess and "
            "largest error, both of max|g|): " + "; ".join(
                f"{n} {e:.3g} {m:.3g}" for e, n, m in sorted(bad)[::-1][:3]))
    largest = (f"largest error {worst[False]:.3g} of max|g|" if split is None
               else f"largest error of max|g|: {worst[True]:.3g} in the "
               f"{split} gradients, {worst[False]:.3g} in the others")
    return (f"losses equal to rtol 1e-6 ({', '.join(f'{k} {v:.6g}' for k, v in gl.items())}); "
            f"{len(wg)} gradients within rtol 1e-4 / atol {atol:g} max|g|, "
            f"{largest}; zero on both paths: {len(zero)}")


def phase_train(dev, tmp: Path) -> dict:
    cfg = M.MaskRCNNConfig()
    model = M.build_model(cfg)
    sd = synthetic_state_dict(model, SEED + 7)
    # a trained network's FrozenBN statistics match its activations: the
    # stem's variance is set to that of the mean-subtracted pixels it sees,
    # so activations are of unit scale and SGD at upstream's learning rate
    # does not blow them up in a few steps, as it does from unit variances
    sd["backbone.body.stem.bn1.running_var"] *= PIXEL_VAR
    model.load_state_dict(sd, strict=True)
    data = SyntheticDataset(SEED + 7)
    model = model.to(dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    kernels.reset_launch_counts()
    model, it, history = TL.do_train(
        data, cfg, model=model, max_steps=TRAIN_STEPS, ims_per_batch=2,
        checkpoint_period=TRAIN_STEPS, log_every=1, output_dir=str(tmp),
        device=dev)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: TRAIN_STEPS * v for k, v in PER_STEP.items()}
    if it != TRAIN_STEPS or counts != want:
        raise AssertionError(f"{it} iterations launched {counts}; want "
                             f"{TRAIN_STEPS} launching {want}")
    bad = [h for h in history if not all(np.isfinite(v) for v in h.values())]
    if bad or len(history) != TRAIN_STEPS:
        raise AssertionError(f"losses not finite: {bad}")
    after = model.state_dict()
    frozen = frozen_names(model)
    moved_frozen = [k for k in frozen if not torch.equal(after[k], before[k])]
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    still = [n for n in trainable if torch.equal(after[n], before[n])]
    if moved_frozen or still or set(trainable) & set(frozen):
        raise AssertionError(f"frozen that moved: {moved_frozen}; trainable "
                             f"that did not: {still}")
    fresh = M.build_model(cfg)
    ckpt = torch.load(tmp / f"model_{TRAIN_STEPS:07d}.pth", weights_only=True)
    fresh.load_state_dict(ckpt["model"], strict=True)
    log(f"[9 train] do_train {it} iterations at B = 2 on the 800x1344 canvas: "
        f"launches {counts} ({PER_STEP} per step); total loss "
        f"{[round(h['total'], 4) for h in history]}; {len(frozen)} frozen "
        f"tensors still, {len(trainable)} trainable parameters moved; "
        f"model_{TRAIN_STEPS:07d}.pth loads with strict=True")

    # one step on one batch through the kernels and the plain versions,
    # with the same draws; TF32 off so only the kernels differ
    rng = np.random.default_rng(SEED + 8)
    batch = TL.batch_to_device([TL.build_train_example(data, i, rng=rng)
                                for i in data.image_ids[:2]], dev)
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        kernels.reset_launch_counts()
        got = step_grads(model, *batch, seed=SEED + 9)
        path_counts = kernels.launch_counts()
        with kernels.force_plain():
            want = step_grads(model, *batch, seed=SEED + 9)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    if path_counts != PER_STEP:
        raise AssertionError(f"kernel-path step launched {path_counts}")
    log(f"[9 train] one step, kernels vs plain (cudnn.allow_tf32 False, "
        f"matmul precision {torch.get_float32_matmul_precision()}): "
        f"{compare_steps(got, want)}")
    return {"model": model, "batch": batch, "counts": counts}


# ---------------------------------------------------------------------------
# phase 10: YOLACT++ inference
# ---------------------------------------------------------------------------


def synthetic_yolact_state_dict(model: torch.nn.Module, seed: int,
                                offset_scale: float = OFFSET_SCALE) -> dict:
    """Upstream-keyed random YOLACT weights from a numpy seed: BN stats
    near 1, conv weights N(0, 1/fan), small biases. The DCN offset convs
    get ``offset_scale`` times that (upstream zero-initialises them, and
    zero offsets would make every DCN a plain conv): at OFFSET_SCALE their
    offsets span a few pixels with fractional parts and some taps leave
    the map."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.int64)
            continue
        if k.endswith("running_var") or (k.endswith(".weight")
                                         and len(shape) == 1):
            a = rng.uniform(0.7, 1.3, shape)
        elif k.endswith(".weight"):
            a = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
            if "conv_offset_mask" in k:
                a *= offset_scale
            elif k.endswith("conf_layer.weight"):
                a *= CONF_SCALE
        elif k.endswith("running_mean"):
            a = rng.standard_normal(shape) * 0.05
        else:  # biases
            a = rng.standard_normal(shape) * 0.02
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def calibrate_yolact_gate(model, images: torch.Tensor, want=(10, 80),
                          margin: float = 1e-4) -> float:
    """Add to the class layer's background biases the least shift (a grid
    of 0.05) after which every image of ``images`` (normalised [B, 3, S,
    S]) has ``want[0]``..``want[1]`` priors whose best class score passes
    ``conf_thresh``, and no prior's best score lies within ``margin`` of
    it (random weights give no trained network's wide gap between
    background and objects). A shift of the background logit moves every
    score without another forward. Returns the shift."""
    cfg = model.cfg
    with torch.no_grad():
        conf = model(images)["conf"].double()
        fg_max = conf[..., 1:].amax(-1)
        fg_lse = torch.logsumexp(conf[..., 1:], -1)
        for shift in np.arange(0.0, 40.0, 0.05):
            # the best foreground softmax score with the shifted background
            best = torch.exp(fg_max - torch.logaddexp(conf[..., 0] + shift,
                                                      fg_lse))
            n = (best > cfg.conf_thresh).sum(1)
            if (bool(((n >= want[0]) & (n <= want[1])).all())
                    and float((best - cfg.conf_thresh).abs().min()) > margin):
                bias = model.prediction_layers[0].conf_layer.bias
                bias.view(-1, cfg.num_classes)[:, 0] += float(shift)
                return float(shift)
    raise AssertionError("no background shift puts the gate in a gap")


def yolact_images(seed: int, b: int, size: int) -> np.ndarray:
    """[b, size, size, 3] uint8 RGB textured images."""
    rng = np.random.default_rng(seed)
    return np.stack([textured_image(rng, size, size) for _ in range(b)])


def check_yolact(pred: YolactPredictor, det: dict, b: int) -> list:
    """Shapes, finite values, boxes inside the image after upstream's
    post-processing, masks in [0, 1], a detection in every image; returns
    the detection counts."""
    k, s = pred.cfg.max_num_detections, 2 * YM.level_sizes(pred.cfg)[0]
    shapes = {"boxes": (b, k, 4), "scores": (b, k), "classes": (b, k),
              "masks": (b, k, s, s), "valid": (b, k), "mask_scores": (b, k)}
    if {n: tuple(v.shape) for n, v in det.items()} != shapes:
        raise AssertionError(f"YOLACT detections {det.keys()}")
    det = {n: v.float().cpu().numpy() if v.is_floating_point()
           else v.cpu().numpy() for n, v in det.items()}
    counts = det["valid"].sum(1).tolist()
    v = det["valid"]
    if min(counts) == 0 or not all(np.isfinite(det[n][v]).all() for n in (
            "boxes", "scores", "masks", "mask_scores")):
        raise AssertionError(f"YOLACT detections: counts {counts}, or not "
                             "finite")
    if not ((det["masks"] >= 0) & (det["masks"] <= 1)).all() or not (
            (det["scores"][v] > 0) & (det["scores"][v] <= 1)).all():
        raise AssertionError("YOLACT masks or scores outside [0, 1]")
    size = pred.cfg.img_size
    for i in range(b):
        res = pred.postprocess_image({n: a[i] for n, a in det.items()},
                                     size, size)
        if not ((res["boxes"] >= 0) & (res["boxes"] <= size)).all() or (
                res["masks"].shape != (counts[i], size, size)):
            raise AssertionError(f"YOLACT image {i}: post-processed boxes "
                                 "outside the image")
    return counts


def compare_yolact(got: dict, want: dict) -> tuple:
    """Kernel path vs plain path on one batch, detection for detection:
    counts and classes equal, boxes atol 1e-5, scores and mask_scores rtol
    1e-5, masks atol 1e-4. Returns the largest errors."""
    err = {n: 0.0 for n in ("boxes", "scores", "mask_scores", "masks")}
    for i in range(got["valid"].shape[0]):
        gv, wv = got["valid"][i], want["valid"][i]
        if int(gv.sum()) != int(wv.sum()) or not torch.equal(
                got["classes"][i][gv], want["classes"][i][wv]):
            raise AssertionError(f"YOLACT image {i}: detections differ")
        for n, (atol, rtol) in (("boxes", (1e-5, 0)), ("scores", (0, 1e-5)),
                                ("mask_scores", (0, 1e-5)),
                                ("masks", (1e-4, 0))):
            torch.testing.assert_close(got[n][i][gv], want[n][i][wv],
                                       atol=atol, rtol=rtol)
            err[n] = max(err[n], float((got[n][i][gv] - want[n][i][wv])
                                       .abs().max()))
    return err


def phase_yolact(dev) -> dict:
    """YOLACT++-550 R-50-FPN through YolactPredictor on the card, f32 and
    bf16, B = 1 and 8, on synthetic upstream-keyed weights whose DCN
    offsets are not zero: 13 dcn_sample launches per forward, sane
    detections, and kernels vs plain (TF32 off) detection for detection."""
    cfg = yolact_model_config("yolact_plus_resnet50")
    model = YM.build_model(cfg)
    model.load_state_dict(synthetic_yolact_state_dict(model, SEED),
                          strict=True)
    images = yolact_images(SEED, 8, cfg.img_size)
    model = model.to(dev)
    shift = calibrate_yolact_gate(
        model, yolact_preprocess(torch.from_numpy(images).to(dev),
                                 cfg.img_size), want=(10, 500), margin=0.0)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    preds = {dt: YolactPredictor(cfg, state_dict=sd, dtype=dt, device=dev)
             for dt in (torch.float32, torch.bfloat16)}
    per_forward = {"nms": 0, "roi_align": 0, "roi_align_bwd": 0,
                   "dcn_sample": sum(DCN_PER_FORWARD), "dcn_sample_bwd": 0}
    lines = []
    for dt, pred in preds.items():
        for b in (1, 8):
            kernels.reset_launch_counts()
            det = pred.run_batch(images[:b])
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            if counts != per_forward:
                raise AssertionError(f"YOLACT {dt} B={b} launched {counts}; "
                                     f"want {per_forward}")
            lines.append(f"{str(dt)[6:]} B={b}: detections "
                         f"{check_yolact(pred, det, b)}")
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = preds[torch.float32].run_batch(images)
        with kernels.force_plain():
            want = preds[torch.float32].run_batch(images)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    err = compare_yolact(got, want)
    # the greedy-NMS option (use_fast_nms=False): one NMS launch per batch
    pred = preds[torch.float32]
    greedy = dataclasses.replace(cfg, use_fast_nms=False)
    with torch.inference_mode():
        raw = {k: v.float() for k, v in pred.model(yolact_preprocess(
            torch.from_numpy(images).to(dev), cfg.img_size)).items()}
        kernels.reset_launch_counts()
        got = YM.detect(raw, pred.priors, greedy, pred.model.maskiou_net)
        greedy_counts = kernels.launch_counts()
        with kernels.force_plain():
            want = YM.detect(raw, pred.priors, greedy, pred.model.maskiou_net)
    if greedy_counts["nms"] != 1:
        raise AssertionError(f"greedy-NMS detect launched {greedy_counts}")
    err_greedy = compare_yolact(got, want)
    log(f"[10 yolact] YolactPredictor, yolact_plus_resnet50 at "
        f"{cfg.img_size}x{cfg.img_size} "
        f"(background logit +{shift:.2f}): {per_forward['dcn_sample']} "
        f"dcn_sample launches per forward; " + "; ".join(lines)
        + "; kernels vs plain, f32 B=8, TF32 off: detections equal, max err "
        + ", ".join(f"{n} {e:.3g}" for n, e in err.items())
        + "; detect with use_fast_nms=False (1 NMS launch), kernel vs plain "
        f"NMS: detections {got['valid'].sum(1).tolist()} equal, max err "
        + ", ".join(f"{n} {e:.3g}" for n, e in err_greedy.items()))
    return {"preds": preds, "images": images, "counts": per_forward}


# ---------------------------------------------------------------------------
# phase 11: YOLACT++ training
# ---------------------------------------------------------------------------


def yolact_step_grads(model, images, targets, priors, draws, loss_cfg) -> tuple:
    """Losses and parameter gradients of one YOLACT training forward +
    backward on the given mask-subset draws."""
    model.zero_grad(set_to_none=True)
    preds, sem = model.forward_train(images)
    losses = YLOSS.total_loss(preds, sem, targets, priors, draws, loss_cfg,
                              maskiou_net=model.maskiou_net)
    losses["total"].backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def phase_yolact_train(dev, tmp: Path) -> dict:
    """yolact_plus_resnet50 at 550 through yolact_train_loop.train, B = 8
    (train-mode BatchNorm), f32 with TF32 convolutions, synthetic
    upstream-keyed weights with non-zero DCN offsets (TRAIN_OFFSET_SCALE)."""
    name = "yolact_plus_resnet50"
    cfg = yolact_model_config(name)
    loss_cfg = yolact_loss_config(name)
    model = YM.build_model(cfg)
    model.load_state_dict(synthetic_yolact_state_dict(
        model, SEED + 11, offset_scale=TRAIN_OFFSET_SCALE), strict=True)
    data = SyntheticYolactDataset(SEED + 11)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model, it, history = YTL.train(
        data, cfg, batch_size=YOLACT_BATCH, max_steps=YOLACT_TRAIN_STEPS,
        save_every=YOLACT_TRAIN_STEPS, save_folder=str(tmp), cfg_name=name,
        log_every=1, loss_cfg=loss_cfg, model=model, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = {k: YOLACT_TRAIN_STEPS * v for k, v in YOLACT_PER_STEP.items()}
    if it != YOLACT_TRAIN_STEPS or counts != want:
        raise AssertionError(f"{it} YOLACT iterations launched {counts}; want "
                             f"{YOLACT_TRAIN_STEPS} launching {want}")
    keys = ("B", "C", "M", "S", "I", "total")
    bad = [h for h in history
           if tuple(h) != keys or not all(np.isfinite(v) for v in h.values())]
    if bad or len(history) != YOLACT_TRAIN_STEPS:
        raise AssertionError(f"YOLACT losses not finite or incomplete: {bad}")
    after = model.state_dict()
    after = {k: v.cpu() for k, v in after.items()}
    still = [n for n, _ in model.named_parameters()
             if torch.equal(after[n], before[n])]
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    stale = [k for k in stats if torch.equal(after[k], before[k])]
    if still or stale or model.freeze_bn:
        raise AssertionError(f"parameters that did not move: {still}; "
                             f"running statistics not updated: {stale}")
    path = ckpt_path(str(tmp), name, it // (len(data.image_ids)
                                            // YOLACT_BATCH), it)
    fresh = YM.build_model(cfg)
    fresh.load_state_dict(torch.load(path, weights_only=True), strict=True)
    n_params = sum(1 for _ in model.parameters())
    log(f"[11 yolact_train] train() {it} iterations at B = {YOLACT_BATCH}, "
        f"{cfg.img_size}x{cfg.img_size}, f32 with TF32 convolutions, "
        f"train-mode BatchNorm, in {seconds:.1f} s: launches {counts} "
        f"({YOLACT_PER_STEP['dcn_sample']} + "
        f"{YOLACT_PER_STEP['dcn_sample_bwd']} per step); losses "
        + "; ".join(", ".join(f"{k} {v:.4g}" for k, v in h.items())
                    for h in history)
        + f"; all {n_params} parameters moved, {len(stats)} running "
        f"statistics updated; {Path(path).name} loads with strict=True")

    # one step on one batch through the kernels and the plain versions,
    # with the same draws; TF32 off and deterministic cuDNN, so that only
    # the kernels differ: with frozen BatchNorm (train() below a batch of
    # 6) at phase 9's tolerance, and in train mode against the spread of
    # the kernel path between two runs
    rng = np.random.default_rng(SEED + 12)
    images, targets = YTL.batch_to_device(
        *next(YTL.batch_iterator(data, cfg, rng, YOLACT_BATCH)), dev)
    priors = torch.from_numpy(YM.make_priors_np(cfg)).to(dev)
    draws = torch.rand((YOLACT_BATCH, priors.shape[0]), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           SEED + 13))
    batch = (images, targets, priors, draws, loss_cfg)
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        model.freeze_bn = True
        model.train()
        kernels.reset_launch_counts()
        got = yolact_step_grads(model, *batch)
        path_counts = kernels.launch_counts()
        with kernels.force_plain():
            want = yolact_step_grads(model, *batch)
        model.freeze_bn = False
        model.train()
        runs = [yolact_step_grads(model, *batch) for _ in range(2)]
        with kernels.force_plain():
            runs += [yolact_step_grads(model, *batch) for _ in range(2)]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = prev
    if path_counts != YOLACT_PER_STEP:
        raise AssertionError(f"YOLACT kernel-path step launched {path_counts}")
    # atol 1e-5 max|g|, not phase 9's 1e-6: an offset conv's gradient sums,
    # over the 38 088 positions of a B = 8 layer2 map, coordinate gradients
    # that are themselves sums over 128-512 channels, which the backward
    # kernel's warps take in another order than the plain torch.sum
    # (measured on an H100: layer2 block 2's offset conv missed 1e-6 max|g|
    # by 1.9e-8)
    log(f"[11 yolact_train] one step, frozen BatchNorm, kernels vs plain "
        f"(cudnn.allow_tf32 False, cudnn.deterministic True, matmul "
        f"precision {torch.get_float32_matmul_precision()}): "
        f"{compare_steps(got, want, atol=1e-5, split='conv_offset_mask')}")
    log(f"[11 yolact_train] one step, train-mode BatchNorm: "
        f"{compare_train_mode(*runs)}")
    return {"model": model, "data": data, "cfg": cfg, "loss_cfg": loss_cfg,
            "batch": (images, targets), "priors": priors, "draws": draws,
            "counts": counts}


def rel_l2(a: dict, b: dict) -> dict:
    """Per gradient, ||a - b|| / ||b|| (0 where b is 0 and a too)."""
    out = {}
    for name, w in b.items():
        norm = float(w.norm())
        diff = float((a[name] - w).norm())
        out[name] = diff / norm if norm else (0.0 if diff == 0 else np.inf)
    return out


def compare_train_mode(k1: tuple, k2: tuple, p1: tuple, p2: tuple) -> str:
    """Kernels and plain, two runs each, with train-mode BatchNorm: losses
    equal to rtol 1e-6 (the forward is the same); per gradient, the
    relative L2 error between the kernel and the plain path within ten
    times the spread of either path between its own two runs, but no less
    than 1e-3 and no more than 1e-2. Train-mode BatchNorm's backward
    subtracts, per channel, the mean of the gradient and of its product
    with the normalised input; that difference of nearly equal sums
    magnifies the rounding of the atomic adds, whose order changes from run
    to run in both backward versions. A kernel that dropped or misplaced a
    term would be off by O(1). Left out by rule: the gradients that are
    zero to rounding on the plain path (max|g| below 1e-6 of the largest:
    the bias of a conv in front of a train-mode BatchNorm, which its batch
    mean cancels); the kernel path's must be too."""
    (l1, g1), (l2, g2), (lp, gp), (_, gp2) = k1, k2, p1, p2
    for k, w in lp.items():
        for got in (l1, l2):
            if not abs(got[k] - w) <= 1e-6 * abs(w):
                raise AssertionError(f"train-mode loss {k}: kernels "
                                     f"{got[k]!r}, plain {w!r}")
    if sorted(g1) != sorted(gp):
        raise AssertionError("the two paths give gradients to other parameters")
    top = max(float(w.abs().max()) for w in gp.values())
    zero = [n for n, w in gp.items() if float(w.abs().max()) <= 1e-6 * top]
    loud = [n for n in zero if float(g1[n].abs().max()) > 1e-6 * top]
    if loud:
        raise AssertionError(f"train-mode gradients zero to rounding on the "
                             f"plain path but not on the kernel path: {loud}")
    live = {n: w for n, w in gp.items() if n not in zero}
    kp = rel_l2(g1, live)
    kk = rel_l2(g1, {n: g2[n] for n in live})
    pp = rel_l2(gp2, live)
    limit = {n: min(max(1e-3, 10 * max(kk[n], pp[n])), 1e-2) for n in kp}
    bad = sorted(((kp[n] / limit[n], n) for n in kp if kp[n] > limit[n]),
                 reverse=True)
    if bad:
        raise AssertionError("train-mode gradients past the limit: " + "; ".join(
            f"{n} kernels vs plain {kp[n]:.3g}, kernels {kk[n]:.3g}, plain "
            f"{pp[n]:.3g}" for _, n in bad[:3]))
    worst = max(kp, key=kp.get)

    def med(d):
        return float(np.median(list(d.values())))

    return (f"losses equal to rtol 1e-6 in both kernel runs; {len(zero)} "
            f"gradients zero to rounding on both paths (max|g| <= 1e-6 of "
            f"{top:.4g}); relative L2 error of the other {len(live)}, kernels "
            f"vs plain: median {med(kp):.3g}, largest {kp[worst]:.3g} "
            f"({worst}, limit {limit[worst]:.3g}); kernels vs kernels: median "
            f"{med(kk):.3g}, largest {max(kk.values()):.3g}; plain vs plain: "
            f"median {med(pp):.3g}, largest {max(pp.values()):.3g}")


# ---------------------------------------------------------------------------
# phase 12: timing
# ---------------------------------------------------------------------------


def time_pair(fn, iters=20) -> tuple:
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    def plain():
        with kernels.force_plain():
            return fn()
    p1 = cuda_time_ms(plain, iters)
    k1 = cuda_time_ms(fn, iters)
    k2 = cuda_time_ms(fn, iters)
    p2 = cuda_time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms, what bounds it): bytes over the memory rate against f32
    operations over the f32 rate, the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nms_pairs(boxes, scores, valid, classes, thr: float) -> int:
    """IoU tests that greedy NMS needs on these inputs: each kept box
    against every lower-scored box still alive at its turn (of its own
    class, for the class-aware NMS), over the batch."""
    total = 0
    for i in range(boxes.shape[0]):
        order = torch.sort(scores[i], descending=True, stable=True).indices
        b = boxes[i][order].double().cpu().numpy()
        alive = valid[i][order].cpu().numpy().copy()
        cls = (classes[i][order].cpu().numpy() if classes is not None
               else np.zeros(len(b), np.int64))
        area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
        for j in range(len(b)):
            if not alive[j]:
                continue
            rest = np.nonzero(alive[j + 1:] & (cls[j + 1:] == cls[j]))[0] + j + 1
            total += rest.size
            iw = (np.minimum(b[j, 2], b[rest, 2]) - np.maximum(b[j, 0], b[rest, 0])
                  + 1).clip(0)
            ih = (np.minimum(b[j, 3], b[rest, 3]) - np.maximum(b[j, 1], b[rest, 1])
                  + 1).clip(0)
            inter = iw * ih
            alive[rest[inter / (area[j] + area[rest] - inter) > thr]] = False
    return total


def nms_bound(boxes, scores, valid, classes, thr) -> tuple:
    n = boxes.numel() // 4
    nbytes = n * (16 + 4 + 1 + 1) + (0 if classes is None else n * 8)
    return bound(nbytes, NMS_OPS_PER_PAIR * nms_pairs(boxes, scores, valid,
                                                      classes, thr))


def pyramid_bytes(itemsize: int) -> int:
    return 2 * 256 * sum(h * w for h, w in LEVEL_HW) * itemsize


def touched_cells(boxes, bidx, levels, p: int) -> int:
    """Distinct (image, level, y, x) cells that the forward's bilinear
    samples give a non-zero weight on these rois: the feature cells the
    function needs."""
    lat, _, _ = sampling._pyramid_lattice(LEVEL_HW, boxes.float(), bidx,
                                          levels, p, 2, STRIDES)
    idx4, w4 = sampling._corners(lat, slice(None))
    return int(torch.unique(idx4[w4 != 0]).numel())


def roi_bound(n: int, p: int, feat_bytes: int, itemsize: int) -> tuple:
    """RoIAlign forward or backward: ``feat_bytes`` of features read (the
    forward) or of their gradient written (the backward), the rois (f32
    boxes, int32 image and level) and [N, 256, P, P] in ``itemsize``;
    4 S*S samples' arithmetic per pooled value."""
    nbytes = feat_bytes + n * (16 + 4 + 4) + n * 256 * p * p * itemsize
    return bound(nbytes, n * 256 * p * p * 4 * ROI_OPS_PER_SAMPLE)


def roi_fwd_bound(case, p: int, itemsize: int) -> tuple:
    """K2 reads only the cells its samples weigh, 256 channels each."""
    _, boxes, bidx, levels = case
    cells = touched_cells(boxes, bidx, levels, p)
    return roi_bound(boxes.shape[0], p, cells * 256 * itemsize, itemsize)


def roi_bwd_bound(n: int, p: int, itemsize: int) -> tuple:
    """K3 writes the gradient of every cell of P2-P5, touched or not."""
    return roi_bound(n, p, pyramid_bytes(itemsize), itemsize)


def kernel_args(module, name: str, fn) -> tuple:
    """The arguments with which ``fn()`` calls ``module.name`` (a kernel
    wrapper that the dispatch imports at call time): to time the launch
    alone, without the torch work around it."""
    seen, real = [], getattr(module, name)

    def spy(*args):
        seen.append(args)
        return real(*args)

    setattr(module, name, spy)
    try:
        fn()
    finally:
        setattr(module, name, real)
    return seen[0]


def phase_timing(dev, pred, train: dict, card: str) -> dict:
    from tpuseg_torch.kernels import nms as nms_kernel

    times = {}
    with torch.inference_mode():
        for label, boxes, scores, valid, classes, thr in nms_cases(dev):
            if label.startswith("dup"):
                continue
            iters = 20 if boxes.shape[1] <= 2048 else 5
            def nms():
                return run_nms(boxes, scores, valid, classes, thr)

            k, p = time_pair(nms, iters)
            args = kernel_args(nms_kernel, "nms_keep", nms)
            alone = cuda_time_ms(lambda: nms_kernel.nms_keep(*args), iters)
            times[f"nms B=2 {label}"] = (k, p) + nms_bound(
                boxes, scores, valid, classes, thr) + (None, alone)
        for n, pp in ((2000, 7), (200, 14)):
            for dt in (torch.float32, torch.bfloat16):
                case = roi_case(dev, n, dt)
                k, p = time_pair(lambda: run_roi(case, pp), iters=10)
                size = torch.tensor([], dtype=dt).element_size()
                times[f"roi_align {str(dt)[6:]} N={n} P={pp}"] = (
                    (k, p) + roi_fwd_bound(case, pp, size))
        for n, pp in BWD_SHAPES:
            for dt in (torch.float32, torch.bfloat16):
                case = bwd_case(dev, n, pp, dt)
                k, p = time_pair(lambda: run_bwd(case, pp, dt), iters=10)
                size = torch.tensor([], dtype=dt).element_size()
                times[f"roi_align_bwd {str(dt)[6:]} N={n} P={pp}"] = (
                    (k, p) + roi_bwd_bound(n, pp, size))
        landscape, _ = synthetic_images(SEED)
        for b in (1, 2):
            images, image_hw = canvas_batch(pred, landscape[:b])
            k, p = time_pair(
                lambda: M.forward_inference(pred.model, images, image_hw),
                iters=5)
            times[f"forward B={b} 800x1344"] = (k, p)
    for name, t in times.items():
        if name.startswith("forward"):
            b = int(name.split("B=")[1][0])
            log(f"[12 timing] {name}: kernels {1e3 * b / t[0]:.2f} img/s "
                f"({t[0]:.3f} ms), plain {1e3 * b / t[1]:.2f} img/s "
                f"({t[1]:.3f} ms) [{card}]")
        else:
            alone = (f" (the kernel launch alone {t[5]:.4f} ms)"
                     if name.startswith("nms") else "")
            log(f"[12 timing] {name}: kernel {t[0]:.4f} ms{alone}, plain "
                f"{t[1]:.4f} ms, bound {t[2]:.4g} ms by {t[3]} [{card}]")

    # the training step (forward, backward, SGD) at B = 2 with TF32
    # convolutions as do_train runs them: kernels, plain once, kernels
    model = train["model"]
    opt = make_optimizer(model, 0.0025)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def step():
        TL.train_step(model, opt, 0.0025 / 3, *train["batch"], gen)

    k1 = cuda_time_ms(step, iters=5, warmup=2)
    with kernels.force_plain():
        p = cuda_time_ms(step, iters=1, warmup=0)
    k2 = cuda_time_ms(step, iters=5, warmup=0)
    k = (k1 + k2) / 2
    times["train step B=2 800x1344"] = (k, p)
    log(f"[12 timing] train step B=2 800x1344: kernels {k:.3f} ms "
        f"({1e3 / k:.3f} it/s; two runs of 5: {k1:.3f}, {k2:.3f}), plain "
        f"{p:.3f} ms ({1e3 / p:.3f} it/s, one step) [{card}]")
    return times


def dcn_touched_cells(sy, sx, h: int, w: int) -> int:
    """Distinct (image, y, x) cells that the samples give a non-zero
    bilinear weight: the feature cells the function needs."""
    b = sy.shape[0]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    ly, lx = sy - y0, sx - x0
    base = (torch.arange(b, device=sy.device) * (h * w))[:, None]
    cells = []
    for yc, wy in ((y0, 1.0 - ly), (y0 + 1, ly)):
        for xc, wx in ((x0, 1.0 - lx), (x0 + 1, lx)):
            ok = ((yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
                  & (wy * wx != 0))
            cells.append(base.expand_as(yc)[ok] + (yc * w + xc)[ok].long())
    return int(torch.unique(torch.cat(cells)).numel())


def dcn_bound(feats, sy, sx) -> tuple:
    """The touched cells' C channels read, sy/sx/m read, [B, S, C] written;
    DCN_OPS_PER_VALUE f32 operations per output value."""
    b, c, h, w = feats.shape
    s, item = sy.shape[1], feats.element_size()
    nbytes = (dcn_touched_cells(sy, sx, h, w) * c * item + b * s * 3 * 4
              + b * s * c * item)
    return bound(nbytes, DCN_OPS_PER_VALUE * b * s * c)


def time_yolact(dev, yolact: dict, card: str) -> dict:
    """dcn_sample against its plain version, its bound and grid_sample at
    each DCN geometry (B = 8, f32 and bf16); the YOLACT++ forward and
    run_batch (preprocess, forward, detect) at B = 1 and 8, f32 and bf16,
    kernels against plain."""
    times = {}
    with torch.inference_mode():
        for h, w, c, st in DCN_SHAPES + (DCN_RAGGED,):
            for dt in (torch.float32, torch.bfloat16):
                feats, sy, sx, m = dcn_case(dev, h, w, c, st, dt)
                k, p = time_pair(
                    lambda: sampling.sample_points(feats, sy, sx, m),
                    iters=10)
                lib = cuda_time_ms(
                    lambda: grid_sample_points(feats, sy, sx, m), iters=10)
                name = (f"dcn_sample {str(dt)[6:]} B={DCN_BATCH} "
                        f"{h}x{w}x{c} s{st}")
                times[name] = (k, p) + dcn_bound(feats, sy, sx) + (lib,)
                log(f"[12 timing] {name}: kernel {k:.4f} ms, plain {p:.4f} "
                    f"ms, bound {times[name][2]:.4g} ms by "
                    f"{times[name][3]}, grid_sample {lib:.4f} ms [{card}]")
        images = torch.from_numpy(yolact["images"]).to(dev)
        for dt, pred in yolact["preds"].items():
            for b in (1, 8):
                x = yolact_preprocess(images[:b], pred.cfg.img_size).to(dt)
                for label, fn in (("forward", lambda: pred.model(x)),
                                  ("run_batch", lambda: pred.run_batch(
                                      images[:b]))):
                    k, p = time_pair(fn, iters=5)
                    name = f"yolact {label} {str(dt)[6:]} B={b}"
                    times[name] = (k, p)
                    log(f"[12 timing] YOLACT++ {label} {str(dt)[6:]} B={b} "
                        f"{images.shape[1]}x{images.shape[2]}: kernels "
                        f"{1e3 * b / k:.2f} img/s ({k:.3f} "
                        f"ms), plain {1e3 * b / p:.2f} img/s ({p:.3f} ms) "
                        f"[{card}]")
    return times


def grid_sample_backward(feats, sy, sx, m, grad):
    """The sampler's backward as PyTorch's: grid_sample's backward
    (align_corners=True, zeros) for the features and the grid, through the
    modulation's product; a closure to time (the graph is kept)."""
    f = feats.detach().requires_grad_()
    h, w = feats.shape[2:]
    grid = torch.stack([2.0 * sx / (w - 1) - 1.0, 2.0 * sy / (h - 1) - 1.0],
                       -1)[:, :, None, :].requires_grad_()
    mm = m.detach().requires_grad_()
    out = F.grid_sample(f, grid.to(feats.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    out = out[..., 0].transpose(1, 2) * mm[..., None].to(feats.dtype)
    return lambda: torch.autograd.grad(out, (f, grid, mm), grad,
                                       retain_graph=True)


def dcn_bwd_bound(feats, sy, sx) -> tuple:
    """The [B, S, C] gradient, the touched cells' C channels and sy/sx/m
    read; d feats [B, C, H, W] (every cell) and d sy/d sx/d m written;
    DCN_BWD_OPS_PER_VALUE f32 operations per sample and channel."""
    b, c, h, w = feats.shape
    s, item = sy.shape[1], feats.element_size()
    nbytes = (b * s * c * item + dcn_touched_cells(sy, sx, h, w) * c * item
              + b * s * 3 * 4 + b * h * w * c * item + b * s * 3 * 4)
    return bound(nbytes, DCN_BWD_OPS_PER_VALUE * b * s * c)


def time_yolact_train(dev, yt: dict, card: str) -> dict:
    """dcn_sample_bwd against its plain version, its bound and
    grid_sample's backward at each DCN geometry (B = 8, f32 and bf16); the
    host's time to build one B = 8 batch; the YOLACT++ training step at
    B = 8 (forward, backward, SGD; TF32 convolutions as train() runs it),
    kernels against plain."""
    times = {}
    for h, w, c, st in DCN_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            feats, sy, sx, m = dcn_case(dev, h, w, c, st, dt)
            grad = dcn_grad(dev, feats, sy)
            k, p = time_pair(lambda: run_dcn_bwd(grad, feats, sy, sx, m),
                             iters=10)
            lib = cuda_time_ms(grid_sample_backward(feats, sy, sx, m, grad),
                               iters=10)
            name = (f"dcn_sample_bwd {str(dt)[6:]} B={DCN_BATCH} "
                    f"{h}x{w}x{c} s{st}")
            times[name] = (k, p) + dcn_bwd_bound(feats, sy, sx) + (lib,)
            log(f"[12 timing] {name}: kernel {k:.4f} ms, plain {p:.4f} ms, "
                f"bound {times[name][2]:.4g} ms by {times[name][3]}, "
                f"grid_sample backward {lib:.4f} ms [{card}]")
    cfg, data = yt["cfg"], yt["data"]
    batches = YTL.batch_iterator(data, cfg, np.random.default_rng(SEED + 14),
                                 YOLACT_BATCH)
    t0 = time.perf_counter()
    for _ in range(3):
        YTL.batch_to_device(*next(batches), dev)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / 3 * 1e3
    times[f"yolact host batch B={YOLACT_BATCH}"] = (host,)
    log(f"[12 timing] YOLACT++ host batch (augment + targets + upload) "
        f"B={YOLACT_BATCH}: {host:.1f} ms on the host clock, mean of 3")
    model = yt["model"]
    opt = make_yolact_optimizer(model)
    lr = yolact_lr_schedule()(0)
    images, targets = yt["batch"]

    def step():
        YTL.train_step(model, opt, lr, images, targets, yt["priors"],
                       yt["draws"], yt["loss_cfg"])

    k1 = cuda_time_ms(step, iters=5, warmup=2)
    with kernels.force_plain():
        p = cuda_time_ms(step, iters=2, warmup=1)
    k2 = cuda_time_ms(step, iters=5, warmup=0)
    k = (k1 + k2) / 2
    times[f"yolact train step B={YOLACT_BATCH}"] = (k, p)
    log(f"[12 timing] YOLACT++ train step B={YOLACT_BATCH} "
        f"{cfg.img_size}x{cfg.img_size}: kernels {k:.3f} ms "
        f"({1e3 * YOLACT_BATCH / k:.2f} img/s; two runs of 5: {k1:.3f}, "
        f"{k2:.3f}), plain {p:.3f} ms ({1e3 * YOLACT_BATCH / p:.2f} img/s, "
        f"mean of 2) [{card}]")
    return times


def kernel_entry(name, source, replaces, launches: dict, err, t) -> dict:
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": sum(launches.values()),
             "launches_by_path": launches, "max_abs_err": err, "ms": t[0],
             "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3],
             # no PyTorch call computes NMS or multi-level RoIAlign (or its
             # gradient) without torchvision, which is not a dependency;
             # grid_sample computes DCN sampling, its backward the sampler's
             "library_ms": t[4] if len(t) > 4 else None}
    if len(t) > 5:  # NMS: the launch alone, without the sort around it
        entry["kernel_alone_ms"] = t[5]
    return entry


def ptxas_summary(log_text: str) -> list:
    """'kernel<template args>: N registers, spills S/L bytes' for each
    kernel that ``nvcc -Xptxas -v`` compiled (the names demangled by hand:
    f is f32, 13__nv_bfloat16 bf16, Li4E the integer 4)."""
    out, name = [], None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            base = re.search(r"([a-z_]+_kernel)", mangled).group(1)
            targs = re.search(base + r"I(.*?)EEv", mangled)
            kinds = re.findall(r"13__nv_bfloat16|Li\d+E|f", targs.group(1)
                               ) if targs else []
            parts = ["bf16" if k[0] == "1" else "f32" if k == "f" else k[2:-1]
                     for k in kinds]
            name = base + (f"<{','.join(parts)}>" if parts else "")
            spills = "spills not reported"
        elif "spill stores" in ln and name:
            st, ld = re.findall(r"(\d+) bytes spill", ln)
            spills = f"spills {st}/{ld} bytes"
        elif "registers" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers, {spills}")
            name = None
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke test needs a GPU")
    start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    log(f"[1 card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s); "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"matmul precision {torch.get_float32_matmul_precision()}")

    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    ptxas = ptxas_summary((lib_path.parent / "build.log").read_text())
    log(f"[2 build] {lib_path.relative_to(Path(__file__).resolve().parent)} "
        f"in {time.perf_counter() - t0:.1f} s; ptxas: {'; '.join(ptxas)}")

    nms_res = phase_nms(dev)
    roi_res = phase_roi_align(dev)
    bwd_res = phase_roi_align_bwd(dev)
    dcn_res = phase_dcn(dev)
    dcn_bwd_res = phase_dcn_bwd(dev)
    with tempfile.TemporaryDirectory() as tmp:
        pred, infer_counts = phase_slice(dev, Path(tmp))
        train = phase_train(dev, Path(tmp))
        yolact = phase_yolact(dev)
        yolact_train = phase_yolact_train(dev, Path(tmp))
    times = phase_timing(dev, pred, train, card)
    times.update(time_yolact(dev, yolact, card))
    times.update(time_yolact_train(dev, yolact_train, card))

    def launches(name):
        """Per path: the Mask R-CNN forward, three Mask R-CNN training
        steps, one YOLACT++ forward, three YOLACT++ training steps."""
        return {"inference": infer_counts[name],
                "training": train["counts"][name],
                "yolact_inference": yolact["counts"][name],
                "yolact_training": yolact_train["counts"][name]}

    log(f"[13 total] {time.perf_counter() - start:.1f} s from the start of "
        "main to the end of the timings (the kernels' build included)")
    log(json.dumps({"kernels": [
        kernel_entry("nms", "tpuseg_torch/csrc/nms.cu",
                     "tpuseg/ops/pallas/nms_pl.py:138", launches("nms"),
                     nms_res["max_abs_err"],
                     times["nms B=2 class-aware N=2048"]),
        kernel_entry("roi_align", "tpuseg_torch/csrc/roi_align.cu",
                     "tpuseg/ops/pallas/roi_align_pl.py:576",
                     launches("roi_align"), roi_res["max_abs_err"],
                     times["roi_align float32 N=2000 P=7"]),
        kernel_entry("roi_align_bwd", "tpuseg_torch/csrc/roi_align_bwd.cu",
                     "tpuseg/ops/pallas/roi_align_pl.py:390",
                     launches("roi_align_bwd"), bwd_res["max_abs_err"],
                     times["roi_align_bwd float32 N=1024 P=7"]),
        kernel_entry("dcn_sample", "tpuseg_torch/csrc/dcn_sample.cu",
                     ["tpuseg/ops/pallas/dcn_pl.py:60",
                      "tpuseg/ops/pallas/dcn_pl.py:212"],
                     launches("dcn_sample"), dcn_res["max_abs_err"],
                     times[f"dcn_sample float32 B={DCN_BATCH} 69x69x128 s1"]),
        kernel_entry("dcn_sample_bwd", "tpuseg_torch/csrc/dcn_sample_bwd.cu",
                     "tpuseg/ops/pallas/dcn_pl.py:311",
                     launches("dcn_sample_bwd"), dcn_bwd_res["max_abs_err"],
                     times[f"dcn_sample_bwd float32 B={DCN_BATCH} "
                           "69x69x128 s1"]),
    ]}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
