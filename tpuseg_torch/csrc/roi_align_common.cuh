// Geometry shared by the multi-level RoIAlign forward (roi_align.cu) and
// its transpose (roi_align_bwd.cu), so the two cannot drift apart.
//
// Semantics: ROIAlign_cuda with aligned=False. A roi is scaled to its
// level, its width and height clamp to >= 1, each of its P x P bins holds
// S x S samples at (i + 0.5) / S of the bin. A sample outside [-1, H] (or
// [-1, W]) contributes nothing; otherwise its coordinate clamps to
// [0, H-1] and its upper corner to H-1. Every step is an IEEE-rounded
// intrinsic (no FMA contraction), in the order of the plain versions in
// tpuseg_torch/ops/sampling.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tpuseg_roi {

constexpr int kMaxLevels = 4;

// One level of the pyramid, channels-last [B, H, W, C]. The forward reads
// it in the feature dtype; the backward accumulates into it in f32.
struct Level {
  void* data;
  int h;
  int w;
  float scale;
};

struct Pyramid {
  Level lv[kMaxLevels];
  int num_levels;
};

// Host side: fill a Pyramid from the wrappers' host arrays (level device
// pointers, heights, widths, 1 / stride). Unused slots repeat the last
// level. Returns cudaErrorInvalidValue for 0 or more than 4 levels.
inline int make_pyramid(const void* data, const void* heights,
                        const void* widths, const void* scales, int num_levels,
                        Pyramid* pyr) {
  if (num_levels < 1 || num_levels > kMaxLevels) {
    return (int)cudaErrorInvalidValue;
  }
  pyr->num_levels = num_levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    const int j = i < num_levels ? i : num_levels - 1;
    pyr->lv[i].data = ((void* const*)data)[j];
    pyr->lv[i].h = ((const int*)heights)[j];
    pyr->lv[i].w = ((const int*)widths)[j];
    pyr->lv[i].scale = ((const float*)scales)[j];
  }
  return 0;
}

inline int grid_blocks(long long total, int threads) {
  const long long want = (total + threads - 1) / threads;
  return (int)(want < (1LL << 20) ? want : (1LL << 20));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Element idx of a channels-last [N, P, P, C] array -> (roi, ph, pw, ch).
struct Bin {
  int r, ph, pw, ch;
};

__device__ __forceinline__ Bin decode_bin(long long idx, int p, int c) {
  Bin b;
  b.ch = (int)(idx % c);
  long long t = idx / c;
  b.pw = (int)(t % p);
  t /= p;
  b.ph = (int)(t % p);
  b.r = (int)(t / p);
  return b;
}

// The roi's level and image. Indices come from device memory: clamp so a
// bad one cannot address outside the pyramid.
__device__ __forceinline__ int roi_level(const int* levels, int r,
                                         const Pyramid& pyr) {
  return min(max(levels[r], 0), pyr.num_levels - 1);
}
__device__ __forceinline__ int roi_image(const int* batch_idx, int r,
                                         int batch) {
  return min(max(batch_idx[r], 0), batch - 1);
}

// A roi on its level: origin and bin size (extent clamped to >= 1).
struct RoiGeom {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ RoiGeom roi_geometry(float4 box, float scale,
                                                int p) {
  RoiGeom g;
  g.x1 = __fmul_rn(box.x, scale);
  g.y1 = __fmul_rn(box.y, scale);
  const float roi_w = fmaxf(__fsub_rn(__fmul_rn(box.z, scale), g.x1), 1.0f);
  const float roi_h = fmaxf(__fsub_rn(__fmul_rn(box.w, scale), g.y1), 1.0f);
  g.bin_w = __fdiv_rn(roi_w, (float)p);
  g.bin_h = __fdiv_rn(roi_h, (float)p);
  return g;
}

// Coordinate of sample i of bin `cell` along one axis.
__device__ __forceinline__ float sample_coord(float origin, float bin,
                                              int cell, int i, int s) {
  const float g = __fdiv_rn(__fadd_rn((float)(cell * s + i), 0.5f), (float)s);
  return __fadd_rn(origin, __fmul_rn(g, bin));
}

// One axis of the bilinear sample: clamped low index, high index and the
// two weights. Returns false when the sample lies outside [-1, extent].
struct Axis {
  int lo, hi;
  float wlo, whi;
};

__device__ __forceinline__ bool sample_axis(float t, int extent, Axis* a) {
  const float ef = (float)extent;
  if (t < -1.0f || t > ef) return false;
  const float tc = fminf(fmaxf(t, 0.0f), __fsub_rn(ef, 1.0f));
  const float t0 = floorf(tc);
  a->lo = (int)t0;
  a->hi = min(a->lo + 1, extent - 1);
  a->whi = __fsub_rn(tc, t0);
  a->wlo = __fsub_rn(1.0f, a->whi);
  return true;
}

// One entry of a roi's sample tables (roi_align.cu): a sample's Axis
// along rows or columns and whether it lies inside [-1, extent].
struct AxisEntry {
  Axis a;
  bool valid;
};

// Sample i of bin `cell` along one axis of a roi (origin, bin size) on a
// level of that extent, as sample_axis(sample_coord(...)) gives it.
__device__ __forceinline__ AxisEntry axis_entry(float origin, float bin,
                                                int cell, int i, int s,
                                                int extent) {
  AxisEntry e;
  e.a = Axis{0, 0, 0.0f, 0.0f};
  e.valid = sample_axis(sample_coord(origin, bin, cell, i, s), extent, &e.a);
  return e;
}

// The sample tables of a roi (roi_align.cu): entries ph * S + iy its P * S
// row samples, then P * S + pw * S + ix its column samples, filled by the
// block's threads in a strided loop. The caller synchronises the block
// before reading them.
__device__ __forceinline__ void fill_roi_tables(const RoiGeom& geo,
                                                const Level& L, int p, int s,
                                                AxisEntry* tab) {
  for (int t = threadIdx.x; t < 2 * p * s; t += blockDim.x) {
    const bool row = t < p * s;
    const int j = row ? t : t - p * s;
    const int cell = j / s, i = j - cell * s;
    tab[t] = row ? axis_entry(geo.y1, geo.bin_h, cell, i, s, L.h)
                 : axis_entry(geo.x1, geo.bin_w, cell, i, s, L.w);
  }
}

}  // namespace tpuseg_roi
