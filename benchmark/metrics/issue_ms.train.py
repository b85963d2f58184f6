"""Host milliseconds of ``train_step`` without waiting for the device
at its end (the span ``loop.step`` inside
``detectron_train_loop.py::train_step``: the issue of forward, backward and
SGD), the median over the window's ``loop.iter`` ranges; the models."""
from benchmark.common import program


def read(ctx):
    return program.stage_ms(ctx, "loop.iter", "loop.step")
