"""Milliseconds of the predictor's device pipeline a request (preprocess,
forward, detect: ``YolactPredictor.run_batch``), synchronised at its end
in the traced run only, the median over the window's requests; the
models."""
from benchmark.common.stats import median


def read(ctx):
    per = ctx["spans"].per_item("forward", ctx["t0"], ctx["t1"])
    return 1e3 * median(per.values()) if per else None
