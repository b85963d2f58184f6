"""Device milliseconds a request of the kernels inside the program's
``vit.global_attn`` ranges (each global block's attention in ViTDet's backbone,
``nn/vitdet.py``), read from the ranges' device copies
(``common/vit_attention.py``); the models."""
from benchmark.common import vit_attention as A


def read(ctx):
    return A.device_ms_per_request(ctx, "vit.global_attn")
