"""Host milliseconds a training step spends stacking its batch,
copying the canvas to NCHW and uploading it (the span ``loop.upload`` in
``detectron_train_loop.py::batch_to_device``), the median over the
window's ``loop.iter`` ranges."""
from benchmark.common import program


def read(ctx):
    return program.stage_ms(ctx, "loop.iter", "loop.upload")
