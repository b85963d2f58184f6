// FPN multi-level RoIAlign backward: d(features) from d(pooled), the
// transpose of roi_align.cu (ROIAlign_cuda backward, aligned=False).
//
// Replaces: tpuseg/ops/pallas/roi_align_pl.py::multilevel_roi_align_pallas_bwd
// (the Pallas kernel _make_bwd_kernel; the VJP of make_differentiable_pooler).
// For each roi r, bin (ph, pw), sample (iy, ix) and channel c it adds
// grad[r, c, ph, pw] / (S*S) * wy * wx into each of the sample's four
// corners on level levels[r] of image batch_idx[r]. The sample points,
// weights and border rules are the forward's own (roi_align_common.cuh).
// Boxes get no gradient.
//
// What bounds it on this card: bytes, against which the adds are the
// cost. At the box pooler of a training step (B = 2, N = 1024 rois, P = 7,
// C = 256, f32) the function reads d(pooled) once (51 MB) and writes the
// f32 gradient of P2-P5 (2 x 256 x 89,250 values, 183 MB): ~0.07 ms at
// 3.35 TB/s. Its samples give 205 M weighted corner values. The first
// design added them one by one (one thread per d(pooled) value, 16 scalar
// f32 atomicAdds each, the geometry redone per channel): 0.98 ms on an
// H100 80GB HBM3 at 700 W, and as long at the mask pooler's N = 256,
// P = 14 (the same count). As float4 reductions straight into the buffer
// (this kernel's direct branch) they are 51 M requests, still the larger
// part of the time; a shared-memory window per roi that took every corner
// by a shared f32 atomicAdd before one flush per cell cost about as much
// as it saved. Summing a roi's adds without atomics (below) is what pays;
// PERF.md, section 6, has the times of each design.
//
// Design: one block per (roi, chunk of at most 32 channels), lanes over
// vectors of channels, the roi's adds summed in shared memory first.
//  * The roi's level, image and box are loaded first; the block stages its
//    [P, P, chunk] slice of d(pooled) in shared memory, divided by S*S
//    once per value, from either layout the pooled gradient comes in
//    (NCHW, as the box head's flatten hands it back, or channels-last), so
//    the wrapper copies nothing. The row and column sample tables come from
//    roi_align_common.cuh::fill_roi_tables, the forward's own.
//  * Along each axis the sample coordinates are nondecreasing in the
//    sample index (each step is monotone under round-to-nearest), so one
//    warp per axis numbers the cells its valid samples touch with ballots:
//    at most min(2 P S, extent), and the samples on one cell consecutive.
//  * Merge: the adds into touched cell (ky, kx) are
//    sum_iy wy(iy, ky) sum_ix wx(ix, kx) share[ph(iy), pw(ix)], separable:
//    the row sums U[ph][kx] first (shared memory, one writer each), then
//    each cell's sum over its row samples, reduced once per vector of
//    channels into the global f32 buffer (vec_io.cuh::red_add:
//    red.global.add.v4.f32), a vector of zeros not at all. No shared
//    atomics; at the smoke's box pooler 15 M vector reductions instead of
//    51 M (chip_smoke.py::bwd_merge_counts), 4 M instead of 51 M at the
//    mask pooler's.
//  * Direct, where a roi touches more than kMaxCols columns or the caller
//    turns merging off: lanes over (bin, vector) reduce each sample's four
//    corners straight into the buffer. No roi, P, S or C is refused.
//  * The vector is the widest of float4, float2 and one float that divides
//    C (the buffers are the wrapper's own, aligned). A chunk is the widest
//    of 32, 16, ... channels whose shared memory fits kBudget, so that
//    kMinBlocks blocks share an SM.
// The TPU kernel accumulates each roi's window with a read-modify-write
// DMA that relies on the grid running in order; here blocks run in no
// order and add atomically into zeroed channels-last f32 buffers per level
// [B, H, W, C] that the wrapper allocates and casts once to the feature
// dtype. Accumulation is f32 for f32 and bf16 gradients alike. The share
// grad / (S*S) is IEEE-rounded as in the plain version (tpuseg_torch/ops/
// sampling.py::multilevel_roi_align_backward_plain); the merge sums with
// FMAs in another order and the atomics add in an order that changes from
// run to run, so results agree with the plain version to rounding, not bit
// for bit. A zero share adds nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "roi_align_common.cuh"
#include "vec_io.cuh"

namespace {

using namespace tpuseg_roi;
using namespace tpuseg_vec;

constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;       // resident blocks an SM aims at
constexpr int kChunkLog2 = 5;       // 32 channels of a block, at most
constexpr int kMaxCols = 32;        // touched columns of a roi that merges
constexpr int kBudget = 48 * 1024;  // shared memory a block aims at
constexpr int kStage = 4;           // d(pooled) values a thread loads at once

// A sample of one axis as the merge reads it: the numbers of its low and
// high cells among the roi's touched ones, and its two weights.
struct Tap {
  int lo, hi;
  float wlo, whi;
};

// A block's dynamic shared memory, in bytes from its start, for P*S
// samples per axis and a chunk of `ch` channels: the sample tables, the
// taps, the touched rows and columns and the samples on each, d(pooled)'s
// share, and (when merging) the row sums U[ph][column][channel].
struct Smem {
  int tab, taps, touched, rng, share, u, total;
};

__host__ __device__ inline Smem smem_layout(int p, int s, int ch,
                                            bool merge) {
  const int ps2 = 2 * p * s;  // row samples, then column samples
  Smem m;
  m.tab = 0;
  m.taps = (m.tab + ps2 * (int)sizeof(AxisEntry) + 15) / 16 * 16;
  m.touched = m.taps + ps2 * (int)sizeof(Tap);
  m.rng = m.touched + 2 * ps2 * (int)sizeof(int);
  m.share = (m.rng + 2 * ps2 * (int)sizeof(int2) + 15) / 16 * 16;
  m.u = m.share + p * p * ch * (int)sizeof(float);
  m.total = m.u + (merge ? p * kMaxCols * ch * (int)sizeof(float) : 0);
  return m;
}

// One warp numbers the cells that one axis's n samples touch, in order:
// touched[k] the k-th, rng[k] the first and last sample on it, taps[i]
// sample i's. The valid samples are consecutive and their cells
// nondecreasing (each step of sample_coord, the clamp and floorf is
// monotone), so each sample's cells are new or the last one or two
// numbered, and the samples on one cell are consecutive. Returns the
// count in every lane, or -1 if the cells were not nondecreasing (then
// the block adds directly).
__device__ int compact_axis(const AxisEntry* e, int n, Tap* taps,
                            int* touched, int2* rng) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int base = 0, plo = -1, phi = -1;  // the sample before this round's
  bool pv = false, good = true;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const AxisEntry a = i < n ? e[i] : AxisEntry{};
    const bool v = i < n && a.valid;
    const int lo = a.a.lo, hi = a.a.hi;
    int qlo = __shfl_up_sync(kAll, lo, 1), qhi = __shfl_up_sync(kAll, hi, 1);
    bool qv = __shfl_up_sync(kAll, (int)v, 1);
    if (lane == 0) qlo = plo, qhi = phi, qv = pv;
    const bool after = v && qv;  // a valid sample follows a valid one
    good = good && !(after && (lo < qlo || hi < qhi));
    const bool new_lo = v && !(after && (lo == qlo || lo == qhi));
    const bool new_hi = v && hi != lo && !(after && hi == qhi);
    const unsigned mlo = __ballot_sync(kAll, new_lo);
    const unsigned mhi = __ballot_sync(kAll, new_hi);
    const unsigned below = (1u << lane) - 1u;
    const int at = base + __popc(mlo & below) + __popc(mhi & below);
    const int clo = new_lo ? at : lo == qhi ? at - 1 : at - 2;
    const int chi = new_hi ? at + (int)new_lo : hi == lo ? clo : at - 1;
    if (new_lo) touched[clo] = lo, rng[clo].x = i;
    if (new_hi) touched[chi] = hi, rng[chi].x = i;
    if (v) taps[i] = Tap{clo, chi, a.a.wlo, a.a.whi};
    base += __popc(mlo) + __popc(mhi);
    plo = __shfl_sync(kAll, lo, 31);
    phi = __shfl_sync(kAll, hi, 31);
    pv = __shfl_sync(kAll, (int)v, 31);
  }
  __syncwarp();
  // the last sample on each cell: the next one is past it (or invalid)
  for (int i = lane; i < n; i += 32) {
    if (!e[i].valid) continue;
    const Tap t = taps[i];
    const int next = i + 1 < n && e[i + 1].valid ? taps[i + 1].lo : 1 << 30;
    if (next > t.lo) rng[t.lo].y = i;
    if (t.hi != t.lo && next > t.hi) rng[t.hi].y = i;
  }
  return __all_sync(kAll, good) ? base : -1;
}

// The weight that a sample gives cell k.
__device__ __forceinline__ float weight_on(const Tap& t, int k) {
  const float w = t.lo == k ? t.wlo : 0.0f;
  return t.hi == k ? __fadd_rn(w, t.whi) : w;
}

// VEC (4, 2 or 1) floats of shared memory, aligned to 4 * VEC bytes.
template <int VEC>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *(const float4*)p;
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *(const float2*)p;
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}
template <int VEC>
__device__ __forceinline__ void sts(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *(float2*)p = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    roi_align_bwd_kernel(const Pyramid pyr, int batch, int c,
                         const float4* __restrict__ boxes,
                         const int* __restrict__ batch_idx,
                         const int* __restrict__ levels, int p, int s,
                         const T* __restrict__ grad, int grad_nchw,
                         int ch_log2, int merge) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ch = 1 << ch_log2;
  const Smem lay = smem_layout(p, s, ch, merge);
  AxisEntry* tab = (AxisEntry*)(smem + lay.tab);
  Tap* taps = (Tap*)(smem + lay.taps);
  int* touched = (int*)(smem + lay.touched);
  int2* rng = (int2*)(smem + lay.rng);
  float* share = (float*)(smem + lay.share);
  float* u = (float*)(smem + lay.u);
  __shared__ int counts[2];  // touched rows, columns (or -1)

  const int r = blockIdx.x;
  const int c0 = blockIdx.y * ch;
  const int nch = min(ch, c - c0);
  const int ps = p * s, pp = p * p;
  // the roi's loads first, so that they overlap the staging's
  const int li = roi_level(levels, r, pyr);
  const int img = roi_image(batch_idx, r, batch);
  const float4 box = boxes[r];
  // the block's slice of d(pooled) as share[bin * ch + channel], divided
  // by S*S (a multiplication where that is exact), kStage values a thread
  // in flight. NCHW: a warp per channel, lanes along its P*P bins (the
  // slice is contiguous); channels-last: lanes along the channels.
  const int count = s * s;
  const bool exact = (count & (count - 1)) == 0;
  const float inv_count = 1.0f / (float)count;
  const int bins32 = (pp + 31) >> 5;  // rounds of a warp along the bins
  const float inv_bins32 = 1.0f / (float)bins32;
  const int span = grad_nchw ? nch * bins32 * 32 : pp << ch_log2;
  for (int t0 = 0; t0 < span; t0 += kStage * kThreads) {
    float val[kStage];
    int dst[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int t = t0 + k * kThreads + threadIdx.x;
      int bin, cc;
      size_t at;
      if (grad_nchw) {  // t = (cc * bins32 + round) * 32 + lane
        const int row = t >> 5;
        cc = (int)((float)row * inv_bins32);
        if (cc * bins32 > row) --cc;
        if ((cc + 1) * bins32 <= row) ++cc;
        bin = ((row - cc * bins32) << 5) + (t & 31);
        at = ((size_t)r * c + c0 + cc) * pp + bin;
      } else {
        bin = t >> ch_log2;
        cc = t & (ch - 1);
        at = ((size_t)r * pp + bin) * c + c0 + cc;
      }
      dst[k] = -1;
      if (t >= span || cc >= nch || bin >= pp) continue;
      val[k] = to_f32(grad[at]);
      dst[k] = (bin << ch_log2) + cc;
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k)
      if (dst[k] >= 0)
        share[dst[k]] = exact ? __fmul_rn(val[k], inv_count)
                              : __fdiv_rn(val[k], (float)count);
  }
  // the level by constant indices: indexing the parameter by a register
  // would copy it to each thread's stack
  Level L = pyr.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (li == i) L = pyr.lv[i];
  fill_roi_tables(roi_geometry(box, L.scale, p), L, p, s, tab);
  __syncthreads();
  if (merge) {  // rows by warp 0, columns by warp 1
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const int k = compact_axis(tab + warp * ps, ps, taps + warp * ps,
                                 touched + warp * 2 * ps,
                                 rng + warp * 2 * ps);
      if ((threadIdx.x & 31) == 0) counts[warp] = k;
    }
    __syncthreads();
  }
  float* g = (float*)L.data + (size_t)img * L.h * L.w * c + c0;
  constexpr int kVecLog2 = VEC == 4 ? 2 : VEC == 2 ? 1 : 0;
  const int vl = ch_log2 - kVecLog2;  // vectors of a chunk, log2
  const int vmask = (1 << vl) - 1;
  const int nrows = merge ? counts[0] : -1;
  const int ncols = merge ? counts[1] : -1;

  if (nrows >= 0 && ncols >= 0 && ncols <= kMaxCols) {
    // merge. The roi's adds into touched cell (ky, kx) are
    //   sum over row samples iy on ky and column samples ix on kx of
    //   wy(iy, ky) wx(ix, kx) share[ph(iy), pw(ix)],
    // and share depends on iy only through ph: first the row sums
    // U[ph][kx] = sum_ix wx(ix, kx) share[ph, pw(ix)], then each cell
    // sum_iy wy(iy, ky) U[ph(iy)][kx], reduced once into the buffer.
    // A lane takes a vector of channels; items decode (row, column) by a
    // float reciprocal, corrected by one.
    const float inv = 1.0f / (float)max(ncols, 1);
    const int2* crng = rng + 2 * ps;
    const Tap* ctaps = taps + ps;
    for (int item = threadIdx.x; item < ((p * ncols) << vl);
         item += kThreads) {
      const int v = (item & vmask) * VEC;
      if (v >= nch) continue;
      const int row = item >> vl;
      int ph = (int)((float)row * inv), kx = row - ph * ncols;
      if (kx >= ncols) ++ph, kx -= ncols;
      if (kx < 0) --ph, kx += ncols;
      const int2 rg = crng[kx];
      int pw = rg.x / s, sub = rg.x - pw * s;
      const float* sh = share + ((ph * p) << ch_log2) + v;
      float acc[VEC] = {};
      for (int ix = rg.x; ix <= rg.y; ++ix) {
        const float w = weight_on(ctaps[ix], kx);
        float val[VEC];
        lds<VEC>(sh + (pw << ch_log2), val);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(val[e], w, acc[e]);
        if (++sub == s) sub = 0, ++pw;
      }
      sts<VEC>(u + (row << ch_log2) + v, acc);
    }
    __syncthreads();
    const int* rows = touched;
    const int* cols = touched + 2 * ps;
    for (int item = threadIdx.x; item < ((nrows * ncols) << vl);
         item += kThreads) {
      const int v = (item & vmask) * VEC;
      if (v >= nch) continue;
      const int cell = item >> vl;
      int ky = (int)((float)cell * inv), kx = cell - ky * ncols;
      if (kx >= ncols) ++ky, kx -= ncols;
      if (kx < 0) --ky, kx += ncols;
      const int2 rg = rng[ky];
      int ph = rg.x / s, sub = rg.x - ph * s;
      float acc[VEC] = {};
      for (int iy = rg.x; iy <= rg.y; ++iy) {
        const float w = weight_on(taps[iy], ky);
        float val[VEC];
        lds<VEC>(u + ((ph * ncols + kx) << ch_log2) + v, val);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(val[e], w, acc[e]);
        if (++sub == s) sub = 0, ++ph;
      }
      bool any = false;
#pragma unroll
      for (int e = 0; e < VEC; ++e) any = any || acc[e] != 0.0f;
      if (any)
        red_add<VEC>(g + ((size_t)rows[ky] * L.w + cols[kx]) * c + v, acc);
    }
    return;
  }
  // direct: each (bin, vector) adds its samples' corners into the buffer
  for (int item = threadIdx.x; item < (pp << vl); item += kThreads) {
    const int v = (item & vmask) * VEC;
    if (v >= nch) continue;
    const int bin = item >> vl;
    float sh[VEC];
    lds<VEC>(share + (bin << ch_log2) + v, sh);
    bool any = false;
#pragma unroll
    for (int e = 0; e < VEC; ++e) any = any || sh[e] != 0.0f;
    if (!any) continue;
    const int ph = bin / p, pw = bin - ph * p;
    for (int iy = 0; iy < s; ++iy) {
      const AxisEntry ay = tab[ph * s + iy];
      if (!ay.valid) continue;
      float* row_lo = g + (size_t)ay.a.lo * L.w * c + v;
      float* row_hi = g + (size_t)ay.a.hi * L.w * c + v;
      for (int ix = 0; ix < s; ++ix) {
        const AxisEntry ax = tab[ps + pw * s + ix];
        if (!ax.valid) continue;
        const float w[4] = {__fmul_rn(ay.a.wlo, ax.a.wlo),
                            __fmul_rn(ay.a.wlo, ax.a.whi),
                            __fmul_rn(ay.a.whi, ax.a.wlo),
                            __fmul_rn(ay.a.whi, ax.a.whi)};
        float* at[4] = {row_lo + (size_t)ax.a.lo * c,
                        row_lo + (size_t)ax.a.hi * c,
                        row_hi + (size_t)ax.a.lo * c,
                        row_hi + (size_t)ax.a.hi * c};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float add[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) add[e] = __fmul_rn(sh[e], w[k]);
          red_add<VEC>(at[k], add);
        }
      }
    }
  }
}

template <typename T, int VEC>
int launch_vec(const Pyramid& pyr, int batch, int c, const void* boxes,
               const void* batch_idx, const void* levels, int n, int p, int s,
               const void* grad, int grad_nchw, int ch_log2, int merge,
               int bytes, cudaStream_t stream) {
  auto kernel = roi_align_bwd_kernel<T, VEC>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int ch = 1 << ch_log2;
  kernel<<<dim3(n, (c + ch - 1) / ch), kThreads, bytes, stream>>>(
      pyr, batch, c, (const float4*)boxes, (const int*)batch_idx,
      (const int*)levels, p, s, (const T*)grad, grad_nchw, ch_log2, merge);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* data, const void* heights, const void* widths,
               const void* scales, int num_levels, int batch, int c,
               const void* boxes, const void* batch_idx, const void* levels,
               int n, int p, int s, const void* grad, int grad_nchw,
               int merge, void* stream) {
  Pyramid pyr;
  const int status =
      make_pyramid(data, heights, widths, scales, num_levels, &pyr);
  if (status != 0) return status;
  if (p < 1 || s < 1) return (int)cudaErrorInvalidValue;
  int device = 0, limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  // the widest chunk (at most 2^kChunkLog2 channels, no fewer than four
  // for the budget) within kBudget, so that kMinBlocks blocks share an SM;
  // past the card's limit, a narrower chunk and at last no merging
  int ch_log2 = kChunkLog2;
  while (ch_log2 > 2 && smem_layout(p, s, 1 << ch_log2, merge).total > kBudget)
    --ch_log2;
  while (ch_log2 > 0 && smem_layout(p, s, 1 << ch_log2, merge).total > limit)
    --ch_log2;
  if (smem_layout(p, s, 1 << ch_log2, merge).total > limit) merge = 0;
  const int bytes = smem_layout(p, s, 1 << ch_log2, merge).total;
  if (bytes > limit) return (int)cudaErrorInvalidValue;
  // float4, float2 or one float of the f32 buffers: the widest that
  // divides the row, every level and the chunk
  const int vec_bytes = std::min(
      widest_vector(c * 4, 4, {pyr.lv[0].data, pyr.lv[1].data,
                               pyr.lv[2].data, pyr.lv[3].data}),
      4 << ch_log2);
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec_bytes) {
    case 16:
      return launch_vec<T, 4>(pyr, batch, c, boxes, batch_idx, levels, n, p,
                              s, grad, grad_nchw, ch_log2, merge, bytes, st);
    case 8:
      return launch_vec<T, 2>(pyr, batch, c, boxes, batch_idx, levels, n, p,
                              s, grad, grad_nchw, ch_log2, merge, bytes, st);
    default:
      return launch_vec<T, 1>(pyr, batch, c, boxes, batch_idx, levels, n, p,
                              s, grad, grad_nchw, ch_log2, merge, bytes, st);
  }
}

}  // namespace

// data: host array of num_levels device pointers to zeroed f32
// [B, H_l, W_l, C] (channels-last) gradient buffers, added into;
// heights/widths: host int arrays; scales: host float array (1 / stride).
// boxes [N, 4] f32, batch_idx/levels [N] i32; grad d(pooled) in the pooled
// dtype, [N, C, P, P] contiguous if grad_nchw, else [N, P, P, C]; merge 0
// adds every corner straight into the buffers (no merging in shared
// memory). Requires N >= 1.
extern "C" int tpuseg_roi_align_bwd_f32(const void* data, const void* heights,
                                        const void* widths, const void* scales,
                                        int num_levels, int batch, int c,
                                        const void* boxes,
                                        const void* batch_idx,
                                        const void* levels, int n, int p,
                                        int s, const void* grad, int grad_nchw,
                                        int merge, void* stream) {
  return launch_bwd<float>(data, heights, widths, scales, num_levels, batch,
                           c, boxes, batch_idx, levels, n, p, s, grad,
                           grad_nchw, merge, stream);
}

extern "C" int tpuseg_roi_align_bwd_bf16(const void* data,
                                         const void* heights,
                                         const void* widths,
                                         const void* scales, int num_levels,
                                         int batch, int c, const void* boxes,
                                         const void* batch_idx,
                                         const void* levels, int n, int p,
                                         int s, const void* grad,
                                         int grad_nchw, int merge,
                                         void* stream) {
  return launch_bwd<__nv_bfloat16>(data, heights, widths, scales, num_levels,
                                   batch, c, boxes, batch_idx, levels, n, p, s,
                                   grad, grad_nchw, merge, stream);
}
