"""Host milliseconds a training step spends reading its losses back
(the span ``loop.readback`` around the losses' ``float()`` in ``do_train``:
the host waiting for the device), the median over the window's
``loop.iter`` ranges."""
from benchmark.common import program


def read(ctx):
    return program.stage_ms(ctx, "loop.iter", "loop.readback")
