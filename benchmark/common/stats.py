"""Percentiles and spreads."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) with linear interpolation between
    the order statistics (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 50.0)


def quartile_spread(values) -> float:
    """(third quartile - first quartile) / median, by
    ``statistics.quantiles(values, n=4)``: the spread a bound is set from."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
