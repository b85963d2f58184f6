// FPN multi-level RoIAlign backward: d(features) from d(pooled), the
// transpose of roi_align.cu (ROIAlign_cuda backward, aligned=False).
//
// Replaces: tpuseg/ops/pallas/roi_align_pl.py::multilevel_roi_align_pallas_bwd
// (the Pallas kernel _make_bwd_kernel; the VJP of make_differentiable_pooler).
// For each roi r, bin (ph, pw), sample (iy, ix) and channel c it adds
// grad[r, ph, pw, c] / (S*S) * w into each of the sample's four corners on
// level levels[r] of image batch_idx[r]. The sample points, weights and
// border rules are the forward's own (roi_align_common.cuh). Boxes get no
// gradient.
//
// What bounds it on this card: bytes. At the box pooler of a training step
// (B = 2, N = 1024 rois, P = 7, C = 256, f32) it reads d(pooled) once
// (51 MB) and writes the f32 gradient of P2-P5 (2 x 256 x 89,250 values,
// 183 MB): ~0.07 ms at 3.35 TB/s. Its arithmetic (a division and eight
// multiplications per sample and channel) is negligible. The scattered
// adds are served by the L2 cache, where the atomics resolve.
//
// Design: the TPU kernel accumulates each roi's window with a sequential
// read-modify-write DMA, which relies on the grid running in order; its
// windows, sublane alignment and matmul-folded interpolation are TPU layout
// and are not ported. Here one thread takes one element of d(pooled), with
// the channel the fastest index (the wrapper hands d(pooled) channels-last,
// [N, P, P, C]), and adds its four weighted corners with f32 atomicAdd into
// a channels-last f32 buffer per level [B, H, W, C] that the wrapper
// allocates zeroed. So the 32 threads of a warp add into 32 consecutive
// floats (one 128-byte line) at each corner. Accumulation is f32 for f32
// and bf16 gradients alike (many rois overlap the same cells); the wrapper
// casts the buffer to the feature dtype once at the end, as the TPU kernel
// does. The share grad / (S*S) and each weight are IEEE-rounded as in the
// plain version (tpuseg_torch/ops/sampling.py::
// multilevel_roi_align_backward_plain); only the order of the atomic adds
// differs from run to run, so results agree with the plain version to
// rounding, not bit for bit. A zero share adds nothing and is skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_common.cuh"

namespace {

using namespace tpuseg_roi;

template <typename T>
__global__ void roi_align_bwd_kernel(const Pyramid pyr, int batch, int c,
                                     const float4* __restrict__ boxes,
                                     const int* __restrict__ batch_idx,
                                     const int* __restrict__ levels, int n,
                                     int p, int s,
                                     const T* __restrict__ grad) {
  const long long total = (long long)n * p * p * c;
  const float count = (float)(s * s);
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const float share = __fdiv_rn(to_f32(grad[idx]), count);
    if (share == 0.0f) continue;
    const Bin b = decode_bin(idx, p, c);
    const Level L = pyr.lv[roi_level(levels, b.r, pyr)];
    float* g = (float*)L.data +
               (size_t)roi_image(batch_idx, b.r, batch) * L.h * L.w * c + b.ch;
    const RoiGeom geo = roi_geometry(boxes[b.r], L.scale, p);
    for (int iy = 0; iy < s; ++iy) {
      Axis ay;
      if (!sample_axis(sample_coord(geo.y1, geo.bin_h, b.ph, iy, s), L.h, &ay))
        continue;
      float* row_lo = g + (size_t)ay.lo * L.w * c;
      float* row_hi = g + (size_t)ay.hi * L.w * c;
      for (int ix = 0; ix < s; ++ix) {
        Axis ax;
        if (!sample_axis(sample_coord(geo.x1, geo.bin_w, b.pw, ix, s), L.w,
                         &ax))
          continue;
        atomicAdd(row_lo + (size_t)ax.lo * c,
                  __fmul_rn(share, __fmul_rn(ay.wlo, ax.wlo)));
        atomicAdd(row_lo + (size_t)ax.hi * c,
                  __fmul_rn(share, __fmul_rn(ay.wlo, ax.whi)));
        atomicAdd(row_hi + (size_t)ax.lo * c,
                  __fmul_rn(share, __fmul_rn(ay.whi, ax.wlo)));
        atomicAdd(row_hi + (size_t)ax.hi * c,
                  __fmul_rn(share, __fmul_rn(ay.whi, ax.whi)));
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* data, const void* heights, const void* widths,
               const void* scales, int num_levels, int batch, int c,
               const void* boxes, const void* batch_idx, const void* levels,
               int n, int p, int s, const void* grad, void* stream) {
  Pyramid pyr;
  const int status =
      make_pyramid(data, heights, widths, scales, num_levels, &pyr);
  if (status != 0) return status;
  const int threads = 256;
  roi_align_bwd_kernel<T><<<grid_blocks((long long)n * p * p * c, threads),
                            threads, 0, (cudaStream_t)stream>>>(
      pyr, batch, c, (const float4*)boxes, (const int*)batch_idx,
      (const int*)levels, n, p, s, (const T*)grad);
  return (int)cudaGetLastError();
}

}  // namespace

// data: host array of num_levels device pointers to zeroed f32
// [B, H_l, W_l, C] (channels-last) gradient buffers, added into;
// heights/widths: host int arrays; scales: host float array (1 / stride).
// boxes [N, 4] f32, batch_idx/levels [N] i32, grad [N, P, P, C] in the
// pooled dtype. Requires N >= 1.
extern "C" int tpuseg_roi_align_bwd_f32(const void* data, const void* heights,
                                        const void* widths, const void* scales,
                                        int num_levels, int batch, int c,
                                        const void* boxes,
                                        const void* batch_idx,
                                        const void* levels, int n, int p,
                                        int s, const void* grad,
                                        void* stream) {
  return launch_bwd<float>(data, heights, widths, scales, num_levels, batch,
                           c, boxes, batch_idx, levels, n, p, s, grad, stream);
}

extern "C" int tpuseg_roi_align_bwd_bf16(const void* data,
                                         const void* heights,
                                         const void* widths,
                                         const void* scales, int num_levels,
                                         int batch, int c, const void* boxes,
                                         const void* batch_idx,
                                         const void* levels, int n, int p,
                                         int s, const void* grad,
                                         void* stream) {
  return launch_bwd<__nv_bfloat16>(data, heights, widths, scales, num_levels,
                                   batch, c, boxes, batch_idx, levels, n, p, s,
                                   grad, stream);
}
