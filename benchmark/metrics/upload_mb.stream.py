"""Megabytes sent to the device per image to build its canvas: the
program's counters ``predictor.upload_bytes`` over ``predictor.images``,
both counted in ``MaskRCNNPredictor.run_on_bgr_images`` (on a CUDA
predictor the uint8 frames and their tap tables, on the host the f32
canvases). A program that does not count the bytes reads nothing."""
from benchmark.common import program


def read(ctx):
    if "predictor.upload_bytes" not in program.counters():
        return None
    return program.counter_ratio("predictor.upload_bytes", "predictor.images",
                                 1e-6)
