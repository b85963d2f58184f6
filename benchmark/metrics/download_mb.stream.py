"""Megabytes of detections brought to the host per image: the
program's counters ``predictor.download_bytes`` over ``predictor.images``,
both counted in ``YolactPredictor.predict_images``."""
from benchmark.common import program


def read(ctx):
    return program.counter_ratio("predictor.download_bytes",
                                 "predictor.images", 1e-6)
