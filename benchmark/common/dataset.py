"""A COCO-style instance dataset on disk, drawn from a mix's parameters
(after ``chip_smoke.py::write_coco_dataset`` and ``textured_image``):
textured PNG images of COCO's common sizes, each with a heavy-tailed
number of polygon objects painted in, a small share of them crowd regions
in uncompressed RLE, category ids from COCO's 91-id space.

The dataset depends only on the mix's ``dataset`` parameters (its own
``seed`` among them), so it is written once per checkout into a fixed
directory under ``build/benchmark/data/``, named by a hash of those
parameters, and read by every later run and by every mix with the same
parameters; a run's ``--seed`` draws the weights, the order, the flips and
the samplers.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

from benchmark.reference.frozen import rle

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / "build" / "benchmark" / "data"
# COCO's 80 category ids in its 91-id space (instances_train2017.json)
COCO_CATEGORY_IDS = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90)
POLY_VERTICES = 16


def textured_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """[h, w, 3] uint8: smooth random blobs plus noise, so the backbone sees
    structure (``chip_smoke.py::textured_image``)."""
    low = rng.uniform(0, 255, (h // 40 + 1, w // 40 + 1, 3))
    img = np.kron(low, np.ones((40, 40, 1)))[:h, :w]
    img += rng.normal(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def instance_counts(rng: np.random.Generator, n: int, mean: float,
                    most: int) -> np.ndarray:
    """Objects per image: geometric (an exponential tail) of ``mean``,
    at least 1, at most ``most``."""
    return np.minimum(rng.geometric(1.0 / mean, n), most)


def draw_image(rng: np.random.Generator, w: int, h: int, n_obj: int,
               spec: dict, first_ann_id: int, image_id: int) -> tuple:
    """One image and its annotations -> (RGB pixels, annotation dicts)."""
    img = textured_image(rng, h, w)
    anns = []
    lo_side, hi_side = spec["box_side"]
    t = np.linspace(0, 2 * np.pi, POLY_VERTICES, endpoint=False)
    for _ in range(n_obj):
        # object sides log-uniform over the shares of the image's sides
        bw, bh = np.exp(rng.uniform(np.log(lo_side), np.log(hi_side), 2)) * [w, h]
        x, y = rng.uniform(0, 1, 2) * ([w, h] - np.asarray([bw, bh]))
        r = rng.uniform(0.8, 1.0, POLY_VERTICES)
        poly = np.stack([x + bw / 2 * (1 + r * np.cos(t)),
                         y + bh / 2 * (1 + r * np.sin(t))], 1).round(2)
        m = rle.decode(rle.poly_to_rle(poly.reshape(-1), h, w)) > 0
        if not m.any():
            continue
        img[m] = rng.integers(0, 256, 3)
        crowd = bool(rng.random() < spec["crowd_share"])
        lo, hi = poly.min(0), poly.max(0)
        segm = ({"size": [h, w],
                 "counts": rle.encode_counts(m.astype(np.uint8)).tolist()}
                if crowd else [poly.reshape(-1).tolist()])
        anns.append({"id": first_ann_id + len(anns), "image_id": image_id,
                     "category_id": int(rng.choice(COCO_CATEGORY_IDS)),
                     "bbox": [float(lo[0]), float(lo[1]),
                              float(hi[0] - lo[0]), float(hi[1] - lo[1])],
                     "area": float(m.sum()), "iscrowd": int(crowd),
                     "segmentation": segm})
    return img, anns


def write(root: Path, spec: dict) -> None:
    """Write the dataset of ``spec`` (a mix's ``dataset``) under ``root``:
    ``images/<id>.png`` and ``instances.json``."""
    from PIL import Image

    rng = np.random.default_rng(spec["seed"])
    sizes = [tuple(s) for s in spec["sizes"]]
    n = spec["images"]
    counts = instance_counts(rng, n, spec["instances_mean"],
                             spec["instances_max"])
    (root / "images").mkdir(parents=True)
    images, anns = [], []
    for i in range(1, n + 1):
        w, h = sizes[int(rng.integers(len(sizes)))]
        img, a = draw_image(rng, w, h, int(counts[i - 1]), spec,
                            len(anns) + 1, i)
        name = f"{i:012d}.png"
        Image.fromarray(img).save(root / "images" / name, compress_level=1)
        images.append({"id": i, "height": h, "width": w, "file_name": name})
        anns += a
    (root / "instances.json").write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": f"c{c}"} for c in COCO_CATEGORY_IDS]}))


def ensure(spec: dict, cache: Path | None = None) -> Path:
    """The dataset's directory, written first if this checkout has none
    (into a scratch directory renamed into place, so a run that is cut
    leaves no half dataset behind)."""
    cache = cache or CACHE
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()
    root = cache / f"coco-{spec['seed']}-{key[:12]}"
    if (root / "instances.json").exists():
        return root
    tmp = cache / f".{root.name}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    write(tmp, spec)
    shutil.rmtree(root, ignore_errors=True)
    os.replace(tmp, root)
    return root
