// FPN multi-level RoIAlign forward (ROIAlign_cuda semantics, aligned=False).
//
// Replaces: tpuseg/ops/pallas/roi_align_pl.py::multilevel_roi_align_pallas
// (the Pallas kernel _make_kernel, weights _interp_pair, geometry _prep).
// Each roi is pooled from its own pyramid level into P x P bins, each bin
// the mean of S x S bilinear samples. Border rule: a sample outside
// [-1, H] x [-1, W] gives 0; otherwise the coordinate is clamped to
// [0, H-1] x [0, W-1] and the upper corner to H-1 / W-1.
//
// What bounds it on this card: the traffic from the L2 to the SMs and,
// unless the per-value work is hoisted, instruction issue. Every output
// value reads 4 corners for each of its S*S samples, from a pyramid of
// 2 x 256 x (200x336 + ... + 25x42) values (183 MB f32 at B = 2), at
// scattered rows and columns; the FLOPs are a few per load. Computed per
// value, as the first design did (one thread per output value), the
// geometry cost ~9 IEEE division sequences and six 64-bit divisions a
// value, identical across the 256 channels of a bin, and instruction issue
// set the pace (bf16 ran no faster than f32). Hoisted into one block per
// (roi, ph) bin row, the corner loads of N = 2000, P = 7 (1.6 GB of 16-byte
// requests in f32) came from the L2 at ~4.6 TB/s (0.34 ms on an H100 80GB
// HBM3 at 700 W): bins of one roi share most of their cells, but not
// within one bin row. The TPU kernel DMAs a window per roi into VMEM and
// interpolates with matmuls; here the SM's L1 holds a roi's cells while
// its bins read them.
//
// Design: one block per (roi, chunk of channels), lanes over (bin, channel
// vector).
//  * The grid is (N, C / chunk): the roi and the channels come from
//    blockIdx, no division. The roi's level, image and geometry are
//    computed once; the block's first threads fill two small shared
//    tables (roi_align_common.cuh::fill_roi_tables): the P*S row samples
//    and the P*S column samples of the roi, each an Axis (clamped indices,
//    two weights) and an inside flag.
//  * A chunk is 16 vectors of channels (256 bytes of each feature cell), so
//    the roi's cells, which its P x P bins share, stay in the SM's L1 while
//    the block reads them: the card's L2 sends each cell's chunk about once
//    per roi, not once per bin row (0.19 ms against the bin rows' 0.35 at
//    N = 2000, P = 7, f32, in one run on the card above). A block has at
//    most 256 threads, in rounds as even as whole warps allow.
//  * Each thread takes one (bin, vector of channels) at a time and walks
//    the bin's S x S samples: four VEC-wide corner loads per sample (16
//    bytes: four f32 or eight bf16 channels), none where the sample lies on
//    the same four cells as the one before, f32 accumulation per channel,
//    one VEC-wide store into the [N, P, P, C] output.
//  * VEC is the widest of 16, 8, 4 and 2 bytes that divides the row
//    (C x itemsize), every level's pointer and the output's; else one
//    element. A ragged C or an unaligned level runs the same arithmetic
//    narrower.
// The wrapper (tpuseg_torch/kernels/roi_align.py) hands each level as an
// NCHW tensor in torch.channels_last memory format, i.e. physically
// [B, H, W, C]; the roi's level picks the base pointer and H, W.
// Accumulation is f32 for f32 and bf16 features; the mean is stored in the
// feature dtype (bf16 rounds to nearest even). Every step is written with
// round-to-nearest intrinsics (no FMA contraction) in the plain version's
// operation order: the sample coordinates, the corner weights, each
// sample's ((w00 v00 + w01 v01) + w10 v10) + w11 v11, the samples added in
// (iy, ix) order, one division by S*S. Hoisting the geometry out of the
// channels changes no rounding, so the kernel's output equals the plain
// version's (tpuseg_torch/ops/sampling.py::multilevel_roi_align_plain) bit
// for bit, in f32 and in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "roi_align_common.cuh"
#include "vec_io.cuh"

namespace {

using namespace tpuseg_roi;
using namespace tpuseg_vec;

constexpr int kMaxThreads = 256;
constexpr int kChunkVectors = 16;  // vectors of channels in a block's chunk

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_kernel(const Pyramid pyr, int batch, int c,
                     const float4* __restrict__ boxes,
                     const int* __restrict__ batch_idx,
                     const int* __restrict__ levels, int p, int s,
                     T* __restrict__ out) {
  constexpr int kBytes = VEC * (int)sizeof(T);
  extern __shared__ AxisEntry tab[];  // [P * S] rows, then [P * S] columns
  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kChunkVectors * VEC;
  const Level L = pyr.lv[roi_level(levels, r, pyr)];
  fill_roi_tables(roi_geometry(boxes[r], L.scale, p), L, p, s, tab);
  __syncthreads();

  const T* f = (const T*)L.data +
               (size_t)roi_image(batch_idx, r, batch) * L.h * L.w * c;
  T* o = out + (size_t)r * p * p * c;
  const int vectors = min(kChunkVectors, (c - c0) / VEC);
  const float count = (float)(s * s);
  for (int item = threadIdx.x; item < p * p * vectors; item += blockDim.x) {
    const int bin = item / vectors;
    const int ph = bin / p, pw = bin - ph * p;
    const int ch = c0 + (item - bin * vectors) * VEC;
    const AxisEntry* rows = tab + ph * s;
    const AxisEntry* cols = tab + p * s + pw * s;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    // the last sample's corners as loaded (bf16 stays packed until used):
    // a sample on the same four cells (common where a bin spans less than
    // a cell) loads nothing
    constexpr int kWords = words<T, VEC>();
    uint32_t v00[kWords], v01[kWords], v10[kWords], v11[kWords];
    int held_y = -1, held_x = -1;
    for (int iy = 0; iy < s; ++iy) {
      const AxisEntry ay = rows[iy];
      if (!ay.valid) continue;
      const T* row_lo = f + (size_t)ay.a.lo * L.w * c + ch;
      const T* row_hi = f + (size_t)ay.a.hi * L.w * c + ch;
      for (int ix = 0; ix < s; ++ix) {
        const AxisEntry ax = cols[ix];
        if (!ax.valid) continue;
        const float w00 = __fmul_rn(ay.a.wlo, ax.a.wlo);
        const float w01 = __fmul_rn(ay.a.wlo, ax.a.whi);
        const float w10 = __fmul_rn(ay.a.whi, ax.a.wlo);
        const float w11 = __fmul_rn(ay.a.whi, ax.a.whi);
        if (ay.a.lo != held_y || ax.a.lo != held_x) {  // hi follows lo
          Raw<kBytes>::load(row_lo + (size_t)ax.a.lo * c, v00);
          Raw<kBytes>::load(row_lo + (size_t)ax.a.hi * c, v01);
          Raw<kBytes>::load(row_hi + (size_t)ax.a.lo * c, v10);
          Raw<kBytes>::load(row_hi + (size_t)ax.a.hi * c, v11);
          held_y = ay.a.lo;
          held_x = ax.a.lo;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float v = __fadd_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(unpack<T>(v00, e), w00),
                                  __fmul_rn(unpack<T>(v01, e), w01)),
                        __fmul_rn(unpack<T>(v10, e), w10)),
              __fmul_rn(unpack<T>(v11, e), w11));
          acc[e] = __fadd_rn(acc[e], v);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], count);
    store_f32<T, VEC>(o + (size_t)bin * c + ch, acc);
  }
}

template <typename T, int VEC>
int launch_vec(const Pyramid& pyr, int batch, int c, const void* boxes,
               const void* batch_idx, const void* levels, int n, int p, int s,
               void* out, cudaStream_t stream) {
  const int chunk = kChunkVectors * VEC;
  // (bin, vector) items of a block, in rounds of at most kMaxThreads
  // threads that are as even as whole warps allow
  const int items = p * p * std::min(kChunkVectors, c / VEC);
  const int rounds = (items + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((items + rounds - 1) / rounds + 31) / 32 * 32;
  const size_t table = (size_t)2 * p * s * sizeof(AxisEntry);
  roi_align_kernel<T, VEC>
      <<<dim3(n, (c + chunk - 1) / chunk), threads, table, stream>>>(
          pyr, batch, c, (const float4*)boxes, (const int*)batch_idx,
          (const int*)levels, p, s, (T*)out);
  return (int)cudaGetLastError();
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
  if (p < 1 || s < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the widest vector that divides the row, every level and the output
  const int vec_bytes = widest_vector(
      c * (int)sizeof(T), (int)sizeof(T),
      {pyr.lv[0].data, pyr.lv[1].data, pyr.lv[2].data, pyr.lv[3].data, out});
  switch (vec_bytes) {
    case 16:
      return launch_vec<T, (int)(16 / sizeof(T))>(
          pyr, batch, c, boxes, batch_idx, levels, n, p, s, out, st);
    case 8:
      return launch_vec<T, (int)(8 / sizeof(T))>(
          pyr, batch, c, boxes, batch_idx, levels, n, p, s, out, st);
    case 4:
      return launch_vec<T, (int)(4 / sizeof(T))>(
          pyr, batch, c, boxes, batch_idx, levels, n, p, s, out, st);
    default:
      return launch_vec<T, 1>(pyr, batch, c, boxes, batch_idx, levels, n, p,
                              s, out, st);
  }
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
