"""The text tools around the card's smoke run, on logs in the smoke's own
formats: the ptxas summary of phase 2 and the side-by-side parser of
``tpuseg_torch.tools.smoke_ab``."""
import chip_smoke
from tpuseg_torch.tools import smoke_ab

BUILD_LOG = """\
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__d11b75cf_6_nms_cu_de8dc8f217nms_reduce_kernelEPKyPKxiiPh' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__d11b75cf_6_nms_cu_de8dc8f217nms_reduce_kernelEPKyPKxiiPh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 128 bytes smem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__63ad1057_13_dcn_sample_cu_785b291517dcn_sample_kernelI13__nv_bfloat16Li8EEEvPKT_PKfS6_S6_iiiiiPS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__63ad1057_13_dcn_sample_cu_785b291517dcn_sample_kernelI13__nv_bfloat16Li8EEEvPKT_PKfS6_S6_iiiiiPS2_
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__b7015402_17_dcn_sample_bwd_cu_42d3b29b21dcn_sample_bwd_kernelIfEEvPKT_PKfS5_S5_S3_iiixxPfS6_S6_S6_' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__b7015402_17_dcn_sample_bwd_cu_42d3b29b21dcn_sample_bwd_kernelIfEEvPKT_PKfS5_S5_S3_iiixxPfS6_S6_S6_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 62 registers, used 0 barriers
"""

SMOKE_LOG = """\
[3 nms] keep masks identical to the plain version: N=819 thr=0.7: 1310/1467 kept
[12 timing] nms B=2 N=2000 thr=0.7: kernel 0.1013 ms (the kernel launch alone 0.0589 ms), plain 10.5899 ms, bound 0.0005771 ms by operations [NVIDIA H100 80GB HBM3, 700.00 W]
[12 timing] forward B=2 800x1344: kernels 86.11 img/s (23.227 ms), plain 23.09 img/s (86.619 ms) [NVIDIA H100 80GB HBM3, 700.00 W]
[12 timing] train step B=2 800x1344: kernels 56.869 ms (17.584 it/s; two runs of 5: 60.734, 53.004), plain 142.306 ms (7.027 it/s, one step) [NVIDIA H100 80GB HBM3, 700.00 W]
[12 timing] dcn_sample bfloat16 B=8 69x69x128 s1: kernel 0.0651 ms, plain 3.4515 ms, bound 0.03033 ms by bytes, grid_sample 0.7451 ms [NVIDIA H100 80GB HBM3, 700.00 W]
[12 timing] YOLACT++ run_batch float32 B=8 550x550: kernels 288.88 img/s (27.693 ms), plain 166.83 img/s (47.954 ms) [NVIDIA H100 80GB HBM3, 700.00 W]
[12 timing] YOLACT++ host batch (augment + targets + upload) B=8: 580.2 ms on the host clock, mean of 3
"""


def test_ptxas_summary_names_each_kernel_with_registers_and_spills():
    assert chip_smoke.ptxas_summary(BUILD_LOG) == [
        "nms_reduce_kernel: 30 registers, spills 0/0 bytes",
        "dcn_sample_kernel<bf16,8>: 40 registers, spills 8/4 bytes",
        "dcn_sample_bwd_kernel<f32>: 62 registers, spills 0/0 bytes"]


def test_smoke_ab_reads_each_timing_in_ms():
    assert smoke_ab.timings(SMOKE_LOG) == {
        "nms B=2 N=2000 thr=0.7": 0.1013,
        "nms B=2 N=2000 thr=0.7 (launch alone)": 0.0589,
        "forward B=2 800x1344": 23.227,
        "train step B=2 800x1344": 56.869,
        "dcn_sample bfloat16 B=8 69x69x128 s1": 0.0651,
        "run_batch float32 B=8 550x550": 27.693}
