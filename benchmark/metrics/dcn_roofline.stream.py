"""K4 (``csrc/dcn_sample.cu``): the least time of the window's DCN
sampling calls, from their sample coordinates' shapes
(``common/roofline.py``), over the kernel's device time in the trace."""
from benchmark.common import roofline as R


def read(ctx):
    return R.roofline_pct(ctx, [("dcn_sample", R.dcn_call_bound)],
                          ("dcn_sample_kernel",))
