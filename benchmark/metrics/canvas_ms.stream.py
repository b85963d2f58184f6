"""Host milliseconds a request spends building its canvas (the span
``predictor.canvas`` in ``MaskRCNNPredictor.run_on_bgr_images``: on a CUDA
predictor the frames' pinned upload and the canvas kernel's issue, on the
host the resize, normalisation and upload), summed over the request's
batch and the median over the window's ``predictor.request`` ranges. A
program without the span reads nothing."""
from benchmark.common import program


def read(ctx):
    if not program._spans(ctx).get("predictor.canvas"):
        return None
    return program.stage_ms(ctx, "predictor.request", "predictor.canvas")
