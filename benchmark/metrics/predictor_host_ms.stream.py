"""Host milliseconds a request spends in the predictor outside its device
pipeline (the upload, the download and the host post-processing: the
masks upsampled to the image), the median over the window's requests of
the request's time less its forward span's; the predictors' host layer."""
from benchmark.common.stats import median


def read(ctx):
    spans = ctx["spans"]
    req = spans.per_item("request", ctx["t0"], ctx["t1"])
    fwd = spans.per_item("forward", ctx["t0"], ctx["t1"])
    host = [req[i] - fwd[i] for i in req if i in fwd]
    return 1e3 * median(host) if host else None
