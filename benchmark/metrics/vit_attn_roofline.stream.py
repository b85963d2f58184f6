"""ViTDet's attention: the least time of every attention call in the
window, from its shapes (``common/vit_attention.py``: the scores, the
relative terms, the softmax and P v against q, k, v, the output and the
tables), over the device time of the kernels inside the calls' ranges."""
from benchmark.common import vit_attention as A


def read(ctx):
    return A.roofline_pct(ctx)
