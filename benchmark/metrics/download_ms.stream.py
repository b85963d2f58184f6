"""Host milliseconds a request spends bringing its detections to the
host (the span ``predictor.download`` around ``.cpu().numpy()`` in
``YolactPredictor.predict_images``: any wait for the device, then the
copy), the median over the window's ``predictor.request`` ranges."""
from benchmark.common import program


def read(ctx):
    return program.stage_ms(ctx, "predictor.request", "predictor.download")
