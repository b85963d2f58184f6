"""The whole step's share of the card's dense TF32 peak: model FLOPs of a
step (forward and backward, counted once at set-up by ``FlopCounterMode``
at the cell's shapes) times the window's steps, over the window, over
495 TFLOP/s."""
from benchmark.common.roofline import TF32_FLOPS_PER_S


def read(ctx):
    if not ctx.get("flops_per_item") or not ctx["items"]:
        return None
    return (100.0 * ctx["flops_per_item"] * ctx["items"] / ctx["window_s"]
            / TF32_FLOPS_PER_S)
