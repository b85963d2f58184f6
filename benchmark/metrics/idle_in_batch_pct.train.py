"""Share of the traced window's device-idle time that lies under the
program's ``loop.batch`` ranges (``do_train``: the iteration's examples
built and uploaded): the idle-time intervals intersected with the union
of those ranges, over all idle time."""
from benchmark.common import program


def read(ctx):
    return program.idle_pct_under(ctx, "loop.batch")
