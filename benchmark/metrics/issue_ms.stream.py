"""Host milliseconds of ``YolactPredictor.run_batch`` without waiting
for the device at its end (the span ``predictor.run`` inside it: as_tensor,
the upload, the issue of preprocess, forward and detect), the median over
the window's ``predictor.request`` ranges; the models."""
from benchmark.common import program


def read(ctx):
    return program.stage_ms(ctx, "predictor.request", "predictor.run")
