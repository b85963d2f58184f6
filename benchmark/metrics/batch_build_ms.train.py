"""Host milliseconds a training step spends building its batch (the
loop's ``build_train_example`` / ``batch_iterator`` and the upload), the
median over the window's steps; the train loops' host layer."""
from benchmark.common.stats import median


def read(ctx):
    per = ctx["spans"].per_item("batch_build", ctx["t0"], ctx["t1"])
    return 1e3 * median(per.values()) if per else None
