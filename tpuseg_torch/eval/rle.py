"""COCO RLE mask codec, byte-compatible with pycocotools (the port's copy
of ``tpuseg/eval/rle.py``; numpy only).

The reference's evaluation layer rides on pycocotools; the port does
not depend on it, and must emit/read the same compressed-RLE
strings (for result JSONs and annotation files). Implemented from the format
specification of the COCO mask API (column-major run lengths; 5-bit LEB-ish
char packing with delta coding from the stride-2 predecessor; polygon
rasterization via the 5x-upsampled boundary walk of ``rleFrPoly``).

All heavy paths are vectorized numpy; mask IoU uses packed-bit popcount.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# dense <-> run lengths (column-major / Fortran order)
# ---------------------------------------------------------------------------


def encode_counts(mask: np.ndarray) -> np.ndarray:
    """Binary mask [H, W] -> run-length counts (starting with a 0-run)."""
    flat = np.asfortranarray(mask).flatten(order="F").astype(bool)
    n = flat.size
    if n == 0:
        return np.zeros(0, np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [n]])
    counts = np.diff(bounds)
    if flat[0]:  # runs must start with a zero-run
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def decode_counts(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Run-length counts -> binary mask [H, W] (uint8)."""
    counts = np.asarray(counts, np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size != h * w:
        raise ValueError(f"RLE size {flat.size} != {h}*{w}")
    return flat.reshape((h, w), order="F")


# ---------------------------------------------------------------------------
# counts <-> compressed string (pycocotools rleToString / rleFrString)
# ---------------------------------------------------------------------------


def counts_to_string(counts: np.ndarray) -> str:
    s = []
    cnts = [int(c) for c in counts]
    for i, c in enumerate(cnts):
        x = c - (cnts[i - 2] if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            s.append(chr(ch + 48))
    return "".join(s)


def string_to_counts(s: str) -> np.ndarray:
    cnts: list[int] = []
    p = 0
    n = len(s)
    while p < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return np.asarray(cnts, np.int64)


def encode(mask: np.ndarray) -> dict:
    """Binary mask [H, W] -> COCO RLE dict {'size': [h, w], 'counts': str}."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": counts_to_string(encode_counts(mask))}


def decode(rle: dict) -> np.ndarray:
    """COCO RLE dict -> binary mask [H, W] uint8.

    Accepts compressed (str/bytes counts) and uncompressed (list counts).
    """
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    if isinstance(counts, str):
        counts = string_to_counts(counts)
    return decode_counts(np.asarray(counts), h, w)


def area(rle: dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    if isinstance(counts, str):
        counts = string_to_counts(counts)
    return int(np.sum(np.asarray(counts, np.int64)[1::2]))


def merge(rles: list[dict]) -> dict:
    """Union of masks (pycocotools merge(..., intersect=0))."""
    if len(rles) == 1:
        return rles[0]
    h, w = rles[0]["size"]
    out = np.zeros((h, w), np.uint8)
    for r in rles:
        out |= decode(r)
    return encode(out)


# ---------------------------------------------------------------------------
# polygon -> RLE (pycocotools rleFrPoly, exact algorithm)
# ---------------------------------------------------------------------------


def poly_to_rle(poly_xy: np.ndarray, h: int, w: int) -> dict:
    """Polygon [x0,y0,x1,y1,...] -> RLE, matching rleFrPoly bit-for-bit."""
    xy = np.asarray(poly_xy, np.float64).reshape(-1, 2)
    k = len(xy)
    scale = 5.0
    # rleFrPoly: x[j] = (int)(scale*xy[j*2+0]+.5) — C truncation (toward
    # zero, NOT floor: slightly negative coords like -0.3 must round to 0
    # the way the C cast does)
    x = np.trunc(scale * xy[:, 0] + 0.5).astype(np.int64)
    y = np.trunc(scale * xy[:, 1] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])

    us: list[np.ndarray] = []
    vs: list[np.ndarray] = []
    for j in range(k):
        xs, xe, ys, ye = x[j], x[j + 1], y[j], y[j + 1]
        dx = abs(xe - xs)
        dy = abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe = xe, xs
            ys, ye = ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx > 0 else 0.0
            d = np.arange(dx + 1)
            t = (dx - d) if flip else d
            u = t + xs
            # v[m]=(int)(ys+s*t+.5): C truncation toward zero, like the
            # vertex quantization above (differs from floor for negatives)
            v = np.trunc(ys + s * t + 0.5).astype(np.int64)
        else:
            s = (xe - xs) / dy if dy > 0 else 0.0
            d = np.arange(dy + 1)
            t = (dy - d) if flip else d
            v = t + ys
            u = np.trunc(xs + s * t + 0.5).astype(np.int64)
        us.append(u)
        vs.append(v)
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # downsample: keep boundary points where u changes
    changed = u[1:] != u[:-1]
    idx = np.flatnonzero(changed) + 1
    xd = np.where(u[idx] < u[idx - 1], u[idx], u[idx] - 1).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    keep = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    yd = np.where(v[idx] < v[idx - 1], v[idx], v[idx - 1]).astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    yd = np.clip(yd, 0, h)
    yd = np.ceil(yd)
    xs_ = xd[keep].astype(np.int64)
    ys_ = yd[keep].astype(np.int64)

    # crossings -> column-major positions -> xor run encoding
    a = np.sort(xs_ * h + ys_)
    a = np.append(a, h * w)
    a = np.diff(np.concatenate([[0], a]))  # deltas (first is a[0]-0)
    # collapse zero deltas by merging adjacent runs
    b: list[int] = [int(a[0])]
    j = 1
    while j < len(a):
        if a[j] > 0:
            b.append(int(a[j]))
            j += 1
        else:
            j += 1
            if j < len(a):
                b[-1] += int(a[j])
                j += 1
    return {"size": [int(h), int(w)], "counts": counts_to_string(np.asarray(b))}


def segm_to_rle(segm, h: int, w: int) -> dict:
    """COCO 'segmentation' field (polygons / uncompressed / compressed) -> RLE."""
    if isinstance(segm, list):  # list of polygons
        rles = [poly_to_rle(np.asarray(p), h, w) for p in segm]
        return merge(rles)
    if isinstance(segm, dict):
        counts = segm["counts"]
        if isinstance(counts, list):  # uncompressed
            return {
                "size": segm["size"],
                "counts": counts_to_string(np.asarray(counts, np.int64)),
            }
        return segm
    raise TypeError(f"unsupported segmentation type {type(segm)}")


# ---------------------------------------------------------------------------
# IoU (packed-bit popcount; crowd semantics as in pycocotools iou)
# ---------------------------------------------------------------------------

_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def mask_iou(dt_rles: list[dict], gt_rles: list[dict], iscrowd: list[int]) -> np.ndarray:
    """[D, G] IoU matrix; crowd gt -> intersection / area(dt)."""
    d, g = len(dt_rles), len(gt_rles)
    if d == 0 or g == 0:
        return np.zeros((d, g))
    h, w = gt_rles[0]["size"] if g else dt_rles[0]["size"]
    dt = np.stack([np.packbits(decode(r).reshape(-1, order="F")) for r in dt_rles])
    gt = np.stack([np.packbits(decode(r).reshape(-1, order="F")) for r in gt_rles])
    dt_area = np.asarray([area(r) for r in dt_rles], np.float64)
    gt_area = np.asarray([area(r) for r in gt_rles], np.float64)
    out = np.zeros((d, g))
    for j in range(g):
        inter = _POPCOUNT[np.bitwise_and(dt, gt[j][None, :])].sum(axis=1)
        if iscrowd[j]:
            denom = dt_area
        else:
            denom = dt_area + gt_area[j] - inter
        out[:, j] = np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)
    return out


def box_iou(dt: np.ndarray, gt: np.ndarray, iscrowd: list[int]) -> np.ndarray:
    """xywh boxes, pycocotools bbIou semantics (crowd -> inter/area_dt)."""
    d, g = len(dt), len(gt)
    out = np.zeros((d, g))
    if d == 0 or g == 0:
        return out
    dt = np.asarray(dt, np.float64)
    gt = np.asarray(gt, np.float64)
    dt_a = dt[:, 2] * dt[:, 3]
    gt_a = gt[:, 2] * gt[:, 3]
    for j in range(g):
        ix = np.minimum(dt[:, 0] + dt[:, 2], gt[j, 0] + gt[j, 2]) - np.maximum(
            dt[:, 0], gt[j, 0]
        )
        iy = np.minimum(dt[:, 1] + dt[:, 3], gt[j, 1] + gt[j, 3]) - np.maximum(
            dt[:, 1], gt[j, 1]
        )
        inter = np.clip(ix, 0, None) * np.clip(iy, 0, None)
        denom = dt_a if iscrowd[j] else dt_a + gt_a[j] - inter
        out[:, j] = np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)
    return out
