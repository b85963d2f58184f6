"""Megabytes uploaded per training batch: the program's counters
``loop.upload_bytes`` (every tensor sent) over ``loop.batches``, both
counted in ``detectron_train_loop.py::batch_to_device``."""
from benchmark.common import program


def read(ctx):
    return program.counter_ratio("loop.upload_bytes", "loop.batches", 1e-6)
