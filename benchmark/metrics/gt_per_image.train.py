"""Gt masks cropped per image built in the window: the program's
counters ``loop.gt_objects`` over ``loop.images``, both counted in
``detectron_train_loop.py::build_train_example``."""
from benchmark.common import program


def read(ctx):
    return program.counter_ratio("loop.gt_objects", "loop.images")
