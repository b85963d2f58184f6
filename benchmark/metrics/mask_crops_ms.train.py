"""Host milliseconds a training step spends cropping each gt mask to its
box (the span ``loop.mask_crops`` around the ``crop_mask`` loop of
``build_train_example``), the median over the window's ``loop.iter``
ranges."""
from benchmark.common import program


def read(ctx):
    return program.stage_ms(ctx, "loop.iter", "loop.mask_crops")
