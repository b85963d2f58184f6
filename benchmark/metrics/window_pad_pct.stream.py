"""Share of the windowed blocks' attention rows that are padding: the
program's counters ``vit.window_pad_tokens`` over ``vit.window_tokens``,
both counted in ``nn/vitdet.py::window_partition``."""
from benchmark.common import program


def read(ctx):
    return program.counter_ratio("vit.window_pad_tokens",
                                 "vit.window_tokens", 100.0)
