"""Host milliseconds a training step spends on its targets: polygons
rasterised to full-size masks (the span ``loop.gt_masks`` around
``dataset.load_target`` in ``build_train_example``), the median over the
window's ``loop.iter`` ranges."""
from benchmark.common import program


def read(ctx):
    return program.stage_ms(ctx, "loop.iter", "loop.gt_masks")
