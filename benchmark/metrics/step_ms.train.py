"""Milliseconds of the loop's ``train_step``, synchronised at its end (in
the traced run only), the median over the window's steps; the models."""
from benchmark.common.stats import median


def read(ctx):
    per = ctx["spans"].per_item("step", ctx["t0"], ctx["t1"])
    return 1e3 * median(per.values()) if per else None
