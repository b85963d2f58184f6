"""Host milliseconds a request spends in ``postprocess_image`` (the span
``predictor.paste``: masks upsampled to the image and binarised, boxes
scaled), summed over the request's images and the median over the
window's ``predictor.request`` ranges."""
from benchmark.common import program


def read(ctx):
    return program.stage_ms(ctx, "predictor.request", "predictor.paste")
