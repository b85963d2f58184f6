"""K2 and K3 together (``csrc/roi_align.cu``, ``csrc/roi_align_bwd.cu``):
the least time of every call in the window, from its rois' shapes
(``common/roofline.py``), over the kernels' device time in the trace."""
from benchmark.common import roofline as R


def read(ctx):
    return R.roofline_pct(ctx, [("roi_align", R.roi_call_bound),
                                ("roi_align_bwd", R.roi_call_bound)],
                          ("roi_align_kernel", "roi_align_bwd_kernel"))
