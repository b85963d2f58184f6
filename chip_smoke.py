#!/usr/bin/env python3
"""GPU smoke test of tpuseg_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (builds the kernels from tpuseg_torch/csrc).
Phases, one line each; any failure raises and exits non-zero:
  1. the card (nvidia-smi name and power limit);
  2. build of the CUDA kernels;
  3. the NMS kernel against its plain version at the main path's shapes
     (keep masks identical);
  4. the RoIAlign kernel against its plain version at the main path's shapes
     (f32: atol = rtol = 1e-5; bf16: |err| <= 2^-8 |ref| + 1e-3, ref the
     plain version computed in f32 on the same bf16 inputs);
  5. Mask R-CNN R-50-FPN inference through MaskRCNNPredictor on the card
     (full width, 81 classes, synthetic upstream-keyed weights from a numpy
     seed): launch counts per forward, sane outputs, and the heads run on
     one shared pyramid through the kernels and through the plain versions
     must agree detection for detection;
  6. timings: each kernel against its plain version, forward img/s at
     B = 1 and 2 on the 800x1344 canvas through both paths.
Then one JSON line of kernel results, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpuseg_torch import kernels
from tpuseg_torch.engine.maskrcnn_engine import (MaskRCNNPredictor,
                                                 preprocess_image_bgr)
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.ops import nms as nms_ops
from tpuseg_torch.ops import sampling

SEED = 0
CANVAS = (800, 1344)
LEVEL_HW = [(200, 336), (100, 168), (50, 84), (25, 42)]
STRIDES = (4, 8, 16, 32)
# cls_score weights N(0, 1/fan) times this: a few hundred class-box
# candidates pass score_thresh = 0.05 (so the final NMS has real work), fewer
# than the 2048 slots (so the candidate cut is not decided by near-ties), and
# no softmax score saturates at 1.0 (272 candidates at a 320x480 canvas)
CLS_SCORE_SCALE = 0.008


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
    """(label, boxes, scores, valid, classes or None, thr) at the main path's
    shapes: B = 2; N = 819 (P6), 1000 (RPN levels), 2048 (final, class-aware)."""
    g = torch.Generator().manual_seed(SEED + 3)
    cases = []
    for n, thr in ((819, 0.7), (1000, 0.7), (2048, 0.5)):
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
# phase 5: the slice
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


def synthetic_images(seed: int):
    """Two landscape 800x1200 and one portrait 1200x800 BGR images: smooth
    random blobs plus noise, so the backbone sees structure."""
    rng = np.random.default_rng(seed)

    def image(h, w):
        low = rng.uniform(0, 255, (h // 40 + 1, w // 40 + 1, 3))
        img = np.kron(low, np.ones((40, 40, 1)))[:h, :w]
        img += rng.normal(0, 20, (h, w, 3))
        return np.clip(img, 0, 255).astype(np.uint8)

    return [image(800, 1200), image(800, 1200)], image(1200, 800)


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
    per_forward = {"nms": 6, "roi_align": 2}
    if after_l != per_forward or counts != {k: 2 * v for k, v in per_forward.items()}:
        raise AssertionError(f"launches: {after_l} after the landscape batch, "
                             f"{counts} after the portrait image; want "
                             f"{per_forward} per forward")
    ndet = [check_result(r, *img.shape[:2])
            for r, img in zip(res_l + [res_p], landscape + [portrait])]
    if min(ndet) == 0:
        raise AssertionError(f"no detections: {ndet}")
    log(f"[5 slice] predictor on 2 landscape 800x1200 + 1 portrait 1200x800 "
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
    log(f"[5 slice] heads on one pyramid, kernels vs plain: "
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
# phase 6: timing
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


def phase_timing(dev, pred, card: str) -> dict:
    times = {}
    with torch.inference_mode():
        for label, boxes, scores, valid, classes, thr in nms_cases(dev):
            if label.startswith("dup"):
                continue
            k, p = time_pair(lambda: run_nms(boxes, scores, valid, classes, thr))
            times[f"nms B=2 {label}"] = (k, p)
        for n, pp in ((2000, 7), (200, 14)):
            for dt in (torch.float32, torch.bfloat16):
                case = roi_case(dev, n, dt)
                k, p = time_pair(lambda: run_roi(case, pp), iters=10)
                times[f"roi_align {str(dt)[6:]} N={n} P={pp}"] = (k, p)
        landscape, _ = synthetic_images(SEED)
        for b in (1, 2):
            images, image_hw = canvas_batch(pred, landscape[:b])
            k, p = time_pair(
                lambda: M.forward_inference(pred.model, images, image_hw),
                iters=5)
            times[f"forward B={b} 800x1344"] = (k, p)
    for name, (k, p) in times.items():
        if name.startswith("forward"):
            b = int(name.split("B=")[1][0])
            log(f"[6 timing] {name}: kernels {1e3 * b / k:.2f} img/s "
                f"({k:.3f} ms), plain {1e3 * b / p:.2f} img/s ({p:.3f} ms) "
                f"[{card}]")
        else:
            log(f"[6 timing] {name}: kernel {k:.4f} ms, plain {p:.4f} ms "
                f"[{card}]")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke test needs a GPU")
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    log(f"[1 card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s); "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"matmul precision {torch.get_float32_matmul_precision()}")

    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    regs = [ln.strip() for ln in (lib_path.parent / "build.log").read_text()
            .splitlines() if "registers" in ln]
    log(f"[2 build] {lib_path.relative_to(Path(__file__).resolve().parent)} "
        f"in {time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(regs)}")

    nms_res = phase_nms(dev)
    roi_res = phase_roi_align(dev)
    with tempfile.TemporaryDirectory() as tmp:
        pred, counts = phase_slice(dev, Path(tmp))
    times = phase_timing(dev, pred, card)

    k_nms, p_nms = times["nms B=2 class-aware N=2048"]
    k_roi, p_roi = times["roi_align float32 N=2000 P=7"]
    log(json.dumps({"kernels": [
        {"name": "nms", "route": "cuda", "source": "tpuseg_torch/csrc/nms.cu",
         "replaces": "tpuseg/ops/pallas/nms_pl.py:138",
         "launches": counts["nms"], "max_abs_err": nms_res["max_abs_err"],
         "ms": k_nms, "plain_ms": p_nms},
        {"name": "roi_align", "route": "cuda",
         "source": "tpuseg_torch/csrc/roi_align.cu",
         "replaces": "tpuseg/ops/pallas/roi_align_pl.py:576",
         "launches": counts["roi_align"],
         "max_abs_err": roi_res["max_abs_err"], "ms": k_roi, "plain_ms": p_roi},
    ]}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
