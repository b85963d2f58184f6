"""The numbers that decide ``correct``, each against its limit from
``limits/<cell>.json``.

Every number is worked out and logged; a cell's ``limits/<cell>.json``
names those it compares (PERF.md gives why each cell compares what it
does, and the readings each limit was set from).

Training, the first steps from the initial state: each checked step's
total loss (``loss_gap`` the worst step, ``loss1_gap`` the first step
alone), the first step's loss terms that no rounding-driven choice feeds
(``terms1_gap``, the worst of the reference's ``STEADY_TERMS``: a
random-weight model's proposals and the samples drawn from them flip with
the last bit of a TF32 convolution, and one flipped roi moves the total
loss by a few thousandths), the first gradient as the optimizer got it
(``grad_gap``) and the parameters' change after the checked steps
(``change_gap``), the last two by the worst leaf: the gap between the
program's norm of a leaf and the reference's, over the reference's norm
of that leaf or of the median leaf, whichever is larger
(``grad_median_gap`` and ``change_median_gap``: the median of those
gaps). Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of the change.
The window's first step, from the program's state before it: its steady
terms (``wterms_gap``), its total loss (``wloss_gap``) and its gradient
by the worst and the median leaf (``wgrad_gap``, ``wgrad_median_gap``).

Detections (what a user of a predictor receives, per image: boxes in
pixels, scores, classes, full-size masks): each reference detection, in
score order, is matched to the unmatched program detection of its class
whose box overlaps it most, at an IoU of 0.5 or more. ``det_miss`` is the
score-weighted share of detections on either side left unmatched (a
detection near the score gate that one side keeps weighs little);
``score_err`` the matched pairs' score differences over their scores;
``mask_err`` the matched pairs' differing mask pixels over their union.
YOLACT crops a mask to its box on the prototype grid, so a box edge that
rounding moves across a grid line moves a strip of the mask, and a pair
whose boxes overlap less may be two neighbouring priors' detections with
masks of their own: ``mask_in_err`` counts the differing pixels of the
pairs whose boxes overlap at an IoU of ``MASK_PAIR_IOU`` or more, inside
both boxes less a prototype pixel on each side, over those pixels.
"""
from __future__ import annotations

import json
import math

import numpy as np
from pathlib import Path

from benchmark.common.stats import median

LIMITS = Path(__file__).resolve().parents[1] / "limits"
NEGLIGIBLE = 1e-3  # of the median leaf's reference gradient


def limits_of(cell: str) -> dict:
    return json.loads((LIMITS / f"{cell}.json").read_text())["limits"]


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Each leaf's |prog - ref| / max(ref, median ref)."""
    names = list(names)
    med = median([ref[n] for n in names])
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def worst_leaf(prog: dict, ref: dict, names) -> tuple:
    """(largest gap, its leaf) of :func:`leaf_gaps`."""
    gaps = leaf_gaps(prog, ref, names)
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def steady_gap(prog: dict, ref: dict, keys) -> float:
    """The worst of ``keys``' relative loss gaps."""
    return max((abs(prog.get(k, math.inf) - ref[k]) / abs(ref[k])
                for k in keys), default=math.inf)


def train_numbers(prog: dict, ref: dict, steady_terms=()) -> tuple:
    """-> ({number: value}, {what was read, for the log})."""
    pl, rl = prog["losses"], ref["losses"]
    p1 = prog["terms"][0] if prog["terms"] else {}
    terms1_gap = steady_gap(p1, ref["terms"][0], steady_terms)
    loss_gaps = ([abs(a - b) / abs(b) for a, b in zip(pl, rl)]
                 if len(pl) == len(rl) and all(map(math.isfinite, pl))
                 else [math.inf])
    names = list(ref["grad_norms"])
    grad_gap, grad_leaf = worst_leaf(prog["grad_norms"], ref["grad_norms"],
                                     names)
    med = median([ref["grad_norms"][n] for n in names])
    moved = [n for n in names if ref["grad_norms"][n] >= NEGLIGIBLE * med]
    change_gap, change_leaf = worst_leaf(prog["change_norms"],
                                         ref["change_norms"], moved)
    pw, rw = prog["window"], ref["window"]
    wnames = list(rw["grad_norms"])
    wgrad_gap, wgrad_leaf = worst_leaf(pw["grad_norms"], rw["grad_norms"],
                                       wnames)
    wtotal = pw["terms"].get("total", math.inf)
    return ({"loss1_gap": loss_gaps[0], "loss_gap": max(loss_gaps),
             "terms1_gap": terms1_gap,
             "grad_gap": grad_gap, "change_gap": change_gap,
             "grad_median_gap": median(leaf_gaps(
                 prog["grad_norms"], ref["grad_norms"], names).values()),
             "change_median_gap": median(leaf_gaps(
                 prog["change_norms"], ref["change_norms"], moved).values()),
             "wterms_gap": steady_gap(pw["terms"], rw["terms"], steady_terms),
             "wloss_gap": (abs(wtotal - rw["terms"]["total"])
                           / abs(rw["terms"]["total"])
                           if math.isfinite(wtotal) else math.inf),
             "wgrad_gap": wgrad_gap,
             "wgrad_median_gap": median(leaf_gaps(
                 pw["grad_norms"], rw["grad_norms"], wnames).values())},
            {"losses": pl, "ref_losses": rl, "loss_gaps": loss_gaps,
             "terms1": p1, "ref_terms1": ref["terms"][0] if ref["terms"] else {},
             "wterms": pw["terms"], "ref_wterms": rw["terms"],
             "grad_leaf": grad_leaf, "change_leaf": change_leaf,
             "wgrad_leaf": wgrad_leaf,
             "leaves": len(names), "leaves_moved": len(moved)})


def verdict(numbers: dict, limits: dict) -> bool:
    """Each number the limits name is finite and within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= v
               for k, v in limits.items())


MATCH_IOU = 0.5
MASK_PAIR_IOU = 0.9


def interior(pb, rb, cell) -> tuple:
    """Rows and columns inside both boxes less a prototype pixel."""
    cy, cx = math.ceil(cell[0]), math.ceil(cell[1])
    return (slice(int(max(pb[1], rb[1])) + cy, int(min(pb[3], rb[3])) - cy),
            slice(int(max(pb[0], rb[0])) + cx, int(min(pb[2], rb[2])) - cx))


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[n, 4] x [m, 4] xyxy -> [n, m]."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)  # noqa
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def match(prog: dict, ref: dict) -> list:
    """[(ref index, program index)] of matched detections."""
    iou = box_iou(np.asarray(ref["boxes"], np.float64),
                  np.asarray(prog["boxes"], np.float64))
    same = (np.asarray(ref["classes"])[:, None]
            == np.asarray(prog["classes"])[None, :])
    iou = np.where(same, iou, -1.0)
    taken, pairs = set(), []
    for r in np.argsort(-np.asarray(ref["scores"]), kind="stable"):
        row = iou[r].copy()
        if taken:
            row[list(taken)] = -1.0
        if row.size and row.max() >= MATCH_IOU:
            p = int(row.argmax())
            taken.add(p)
            pairs.append((int(r), p))
    return pairs


def detection_numbers(progs: list, refs) -> tuple:
    """-> ({number: value}, {what was read, for the log}); ``refs`` may be
    a generator, one image at a time."""
    miss = total = xor = union = ds = s_ref = 0.0
    n_prog = n_ref = n_img = n_pairs = inside = in_diff = 0
    for prog, ref in zip(progs, refs):
        pairs = match(prog, ref)
        ps = np.asarray(prog["scores"], np.float64)
        rs = np.asarray(ref["scores"], np.float64)
        total += ps.sum() + rs.sum()
        miss += (ps.sum() - sum(ps[p] for _, p in pairs)
                 + rs.sum() - sum(rs[r] for r, _ in pairs))
        for r, p in pairs:
            mr = ref["masks"][r].astype(bool)
            mp = prog["masks"][p].astype(bool)
            xor += np.count_nonzero(mr ^ mp)
            union += np.count_nonzero(mr | mp)
            n_pairs += 1
            pb, rb = prog["boxes"][p], ref["boxes"][r]
            if box_iou(np.asarray([pb], np.float64),
                       np.asarray([rb], np.float64))[0, 0] >= MASK_PAIR_IOU:
                rows, cols = interior(pb, rb, ref["cell"])
                inside += mr[rows, cols].size
                in_diff += np.count_nonzero(mr[rows, cols] ^ mp[rows, cols])
            ds += abs(ps[p] - rs[r])
            s_ref += rs[r]
        n_prog += len(ps)
        n_ref += len(rs)
        n_img += 1
    numbers = {"det_miss": miss / total if total else math.inf,
               "mask_err": xor / union if union else math.inf,
               "mask_in_err": in_diff / inside if inside else math.inf,
               "score_err": ds / s_ref if s_ref else math.inf}
    return numbers, {"images": n_img, "program_detections": n_prog,
                     "reference_detections": n_ref, "matched": n_pairs}
