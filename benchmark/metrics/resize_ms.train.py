"""Host milliseconds a training step spends flipping its images and
masks and resizing them onto the canvas (the span ``loop.resize`` in
``build_train_example``: the flip and ``preprocess_image_bgr``), the median
over the window's ``loop.iter`` ranges."""
from benchmark.common import program


def read(ctx):
    return program.stage_ms(ctx, "loop.iter", "loop.resize")
