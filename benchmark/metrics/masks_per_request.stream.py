"""Detections returned per image in the window: the program's counters
``predictor.masks`` over ``predictor.images``, both counted in
``YolactPredictor.predict_images``."""
from benchmark.common import program


def read(ctx):
    return program.counter_ratio("predictor.masks", "predictor.images")
