"""Detectron input conventions (copied from ``tpuseg/ops/preprocess.py``,
which imports jax): BGR input, shortest edge to ``min_size`` capped by
``max_size``, mean subtraction without std."""
from __future__ import annotations

# maskrcnn-benchmark default PIXEL_MEAN (BGR order, used on BGR images)
DETECTRON_PIXEL_MEAN_BGR = (102.9801, 115.9465, 122.7717)


def detectron_target_size(h: int, w: int, min_size: int = 800,
                          max_size: int = 1333):
    """maskrcnn-benchmark Resize.get_size: shortest edge -> min_size capped."""
    size = min_size
    mx = max(h, w)
    mn = min(h, w)
    if mx / mn * size > max_size:
        size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)
