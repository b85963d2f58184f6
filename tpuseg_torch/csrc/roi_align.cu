// FPN multi-level RoIAlign forward (ROIAlign_cuda semantics, aligned=False).
//
// Replaces: tpuseg/ops/pallas/roi_align_pl.py::multilevel_roi_align_pallas
// (the Pallas kernel _make_kernel, weights _interp_pair, geometry _prep).
// Each roi is pooled from its own pyramid level into P x P bins, each bin
// the mean of S x S bilinear samples. Border rule: a sample outside
// [-1, H] x [-1, W] gives 0; otherwise the coordinate is clamped to
// [0, H-1] x [0, W-1] and the upper corner to H-1 / W-1.
//
// What bounds it on this card: memory access, not arithmetic. Every output
// value reads 4 corners for each of its S*S samples, from a pyramid of
// 2 x 256 x (200x336 + ... + 25x42) values (183 MB f32 at B = 2), at
// scattered rows and columns; the FLOPs (a few per load) are negligible.
// The TPU kernel DMAs a window per roi into VMEM and interpolates with
// matmuls; none of that is needed here, where the L1/L2 caches serve the
// reuse between neighbouring samples.
//
// Design: one thread per output element (roi, ph, pw, c) with the channel
// the fastest index, over channels-last levels. The geometry (sample
// points, border rules) lives in roi_align_common.cuh, which the backward
// kernel (roi_align_bwd.cu) shares. The wrapper
// (tpuseg_torch/kernels/roi_align.py) hands each level as an NCHW tensor in
// torch.channels_last memory format, i.e. physically [B, H, W, C], and the
// output as [N, P, P, C]. So the 32 threads of a warp read 32 consecutive
// channels of the same corner (one coalesced 128-byte line in f32) and
// write 32 consecutive outputs. The roi's level picks the base pointer and
// H, W. Accumulation is f32 for f32 and bf16 features; the mean is stored
// in the feature dtype (bf16 rounds to nearest even). Every step is written
// with round-to-nearest intrinsics (no FMA contraction) in the plain
// version's operation order: the sample coordinates, the corner weights,
// each sample's ((w00 v00 + w01 v01) + w10 v10) + w11 v11, the samples
// added in (iy, ix) order, one division by S*S. So the kernel's output
// equals the plain version's bit for bit, in f32 and in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_common.cuh"

namespace {

using namespace tpuseg_roi;

template <typename T>
__global__ void roi_align_kernel(const Pyramid pyr, int batch, int c,
                                 const float4* __restrict__ boxes,
                                 const int* __restrict__ batch_idx,
                                 const int* __restrict__ levels, int n, int p,
                                 int s, T* __restrict__ out) {
  const long long total = (long long)n * p * p * c;
  const float count = (float)(s * s);
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const Bin b = decode_bin(idx, p, c);
    const Level L = pyr.lv[roi_level(levels, b.r, pyr)];
    const T* f = (const T*)L.data +
                 (size_t)roi_image(batch_idx, b.r, batch) * L.h * L.w * c +
                 b.ch;
    const RoiGeom geo = roi_geometry(boxes[b.r], L.scale, p);
    float acc = 0.0f;
    for (int iy = 0; iy < s; ++iy) {
      Axis ay;
      if (!sample_axis(sample_coord(geo.y1, geo.bin_h, b.ph, iy, s), L.h, &ay))
        continue;
      const T* row_lo = f + (size_t)ay.lo * L.w * c;
      const T* row_hi = f + (size_t)ay.hi * L.w * c;
      for (int ix = 0; ix < s; ++ix) {
        Axis ax;
        if (!sample_axis(sample_coord(geo.x1, geo.bin_w, b.pw, ix, s), L.w,
                         &ax))
          continue;
        const float v00 = to_f32(row_lo[(size_t)ax.lo * c]);
        const float v01 = to_f32(row_lo[(size_t)ax.hi * c]);
        const float v10 = to_f32(row_hi[(size_t)ax.lo * c]);
        const float v11 = to_f32(row_hi[(size_t)ax.hi * c]);
        const float v = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(v00, __fmul_rn(ay.wlo, ax.wlo)),
                                __fmul_rn(v01, __fmul_rn(ay.wlo, ax.whi))),
                      __fmul_rn(v10, __fmul_rn(ay.whi, ax.wlo))),
            __fmul_rn(v11, __fmul_rn(ay.whi, ax.whi)));
        acc = __fadd_rn(acc, v);
      }
    }
    out[idx] = from_f32<T>(__fdiv_rn(acc, count));
  }
}

template <typename T>
int launch(const void* data, const void* heights, const void* widths,
           const void* scales, int num_levels, int batch, int c,
           const void* boxes, const void* batch_idx, const void* levels, int n,
           int p, int s, void* out, void* stream) {
  Pyramid pyr;
  const int status =
      make_pyramid(data, heights, widths, scales, num_levels, &pyr);
  if (status != 0) return status;
  const int threads = 256;
  roi_align_kernel<T><<<grid_blocks((long long)n * p * p * c, threads),
                        threads, 0, (cudaStream_t)stream>>>(
      pyr, batch, c, (const float4*)boxes, (const int*)batch_idx,
      (const int*)levels, n, p, s, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// data: host array of num_levels device pointers to [B, H_l, W_l, C]
// (channels-last) features; heights/widths: host int arrays; scales: host
// float array (1 / stride). boxes [N, 4] f32, batch_idx/levels [N] i32,
// out [N, P, P, C] in the feature dtype. Requires N >= 1.
extern "C" int tpuseg_roi_align_f32(const void* data, const void* heights,
                                    const void* widths, const void* scales,
                                    int num_levels, int batch, int c,
                                    const void* boxes, const void* batch_idx,
                                    const void* levels, int n, int p, int s,
                                    void* out, void* stream) {
  return launch<float>(data, heights, widths, scales, num_levels, batch, c,
                       boxes, batch_idx, levels, n, p, s, out, stream);
}

extern "C" int tpuseg_roi_align_bf16(const void* data, const void* heights,
                                     const void* widths, const void* scales,
                                     int num_levels, int batch, int c,
                                     const void* boxes, const void* batch_idx,
                                     const void* levels, int n, int p, int s,
                                     void* out, void* stream) {
  return launch<__nv_bfloat16>(data, heights, widths, scales, num_levels,
                               batch, c, boxes, batch_idx, levels, n, p, s,
                               out, stream);
}
