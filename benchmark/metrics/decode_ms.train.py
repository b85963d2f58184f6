"""Host milliseconds a training step spends reading and decoding its
images (the span ``loop.decode`` around ``dataset.load_image`` in
``detectron_train_loop.py::build_train_example``), summed over the step
and the median over the window's ``loop.iter`` ranges."""
from benchmark.common import program


def read(ctx):
    return program.stage_ms(ctx, "loop.iter", "loop.decode")
