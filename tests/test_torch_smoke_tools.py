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


def test_smoke_ab_reads_the_launch_alone_and_the_split_of_each_kernel():
    """RoIAlign's and the DCN backward's lines carry the launch alone as
    NMS's do; the DCN backward's split lines read as timings of their own."""
    card = "[NVIDIA H100 80GB HBM3, 700.00 W]"
    log = "\n".join([
        "[12 timing] roi_align float32 N=1024 P=7: kernel 0.1500 ms (the "
        "kernel launch alone 0.1200 ms), plain 3.2000 ms, bound 0.03 ms by "
        f"bytes {card}",
        "[12 timing] dcn_sample_bwd float32 B=8 69x69x128 s1: kernel 0.2000 "
        "ms (the kernel launch alone 0.1800 ms), plain 8.6 ms, bound 0.06649 "
        f"ms by bytes, grid_sample backward 3.3 ms {card}",
        "[12 timing] dcn_sample_bwd float32 B=8 69x69x128 s1, d feats only: "
        f"kernel 0.1400 ms, the launch alone; both 0.1800 ms {card}"])
    assert smoke_ab.timings(log) == {
        "roi_align float32 N=1024 P=7": 0.15,
        "roi_align float32 N=1024 P=7 (launch alone)": 0.12,
        "dcn_sample_bwd float32 B=8 69x69x128 s1": 0.2,
        "dcn_sample_bwd float32 B=8 69x69x128 s1 (launch alone)": 0.18,
        "dcn_sample_bwd float32 B=8 69x69x128 s1, d feats only": 0.14}


def test_smoke_ab_reads_phase_14_timings():
    """The detectron family's forwards, steps and K1 at its shapes; the C4
    pooler's line, which times no kernel, is not read."""
    card = "[NVIDIA H100 80GB HBM3, 700.00 W]"
    log = "\n".join([
        "[14 timing] c4 forward B=2 800x1344: kernels 31.19 img/s (64.116 "
        f"ms), plain 15.55 img/s (128.591 ms) {card}",
        "[14 timing] retinanet train step B=2 800x1344: kernels 46.589 ms "
        "(21.464 it/s; two runs of 5: 45.790, 47.388), plain 46.112 ms "
        f"(21.686 it/s, one step) {card}",
        "[14 timing] nms C4 inference RPN: nms_mask_batch B=2 N=6000 "
        "thr=0.7 (12000 valid): kernel 0.3643 ms (the kernel launch alone "
        "0.2666 ms), plain 33.7498 ms, bound 0.004554 ms by operations "
        f"{card}",
        "[14 timing] C4 pooler (adaptive RoIAlign 14x14 on (2, 1024, 50, "
        "84), separable form, f32, no kernel): forward 10.382 ms at 2 x 512 "
        f"rois {card}"])
    rpn = ("nms C4 inference RPN: nms_mask_batch B=2 N=6000 thr=0.7 (12000 "
           "valid)")
    assert smoke_ab.timings(log) == {
        "c4 forward B=2 800x1344": 64.116,
        "retinanet train step B=2 800x1344": 46.589,
        rpn: 0.3643, f"{rpn} (launch alone)": 0.2666}


def test_bwd_merge_counts_on_hand_built_rois():
    """The RoIAlign backward's reductions, counted on one 40 x 40 level at
    stride 4, C = 256 (64 float4 vectors a cell): a roi of one cell (all
    its 14 x 14 samples on the cells 2-3 of each axis: 4 cells flushed
    against 784 corners, 3136 at P = 14) and a roi spanning the level. At P = 7 the
    latter's samples lie 2.9 cells apart: 28 x 28 touched cells, one flush
    per corner. At P = 14 they lie 1.4 apart and touch all 40 columns, more
    than the kernel merges (32): the roi adds directly."""
    import torch

    boxes = torch.tensor([[8.0, 8.0, 12.0, 12.0], [0.0, 0.0, 160.0, 160.0]])
    bidx = torch.zeros(2, dtype=torch.int64)
    levels = torch.zeros(2, dtype=torch.int64)

    def counts(p):
        return chip_smoke.bwd_merge_counts(boxes, bidx, levels, p, 2, 256,
                                           [(40, 40)], (4,))

    assert counts(7) == {"corner_adds": 2 * 4 * 14 * 14 * 64,
                         "flushes": 4 * 64 + 28 * 28 * 64,
                         "direct_share": 0.0}
    assert counts(14) == {"corner_adds": 2 * 4 * 28 * 28 * 64,
                          "flushes": 4 * 64 + 4 * 28 * 28 * 64,
                          "direct_share": 0.5}
    one = chip_smoke.bwd_merge_counts(boxes[:1], bidx[:1], levels[:1], 14, 2,
                                      256, [(40, 40)], (4,))
    assert one["flushes"] == 4 * 64 and one["direct_share"] == 0.0
