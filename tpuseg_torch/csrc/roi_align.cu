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
// the fastest index, over channels-last levels. The wrapper
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

namespace {

constexpr int kMaxLevels = 4;

struct Level {
  const void* data;
  int h;
  int w;
  float scale;
};

struct Pyramid {
  Level lv[kMaxLevels];
  int num_levels;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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
    const int ch = (int)(idx % c);
    long long t = idx / c;
    const int pw = (int)(t % p);
    t /= p;
    const int ph = (int)(t % p);
    const int r = (int)(t / p);
    // indices come from device memory: clamp so a bad one cannot read
    // outside the pyramid
    const int lv = min(max(levels[r], 0), pyr.num_levels - 1);
    const int bi = min(max(batch_idx[r], 0), batch - 1);
    const Level L = pyr.lv[lv];
    const T* f = (const T*)L.data + (size_t)bi * L.h * L.w * c + ch;
    const float4 box = boxes[r];
    const float x1 = __fmul_rn(box.x, L.scale);
    const float y1 = __fmul_rn(box.y, L.scale);
    const float roi_w = fmaxf(__fsub_rn(__fmul_rn(box.z, L.scale), x1), 1.0f);
    const float roi_h = fmaxf(__fsub_rn(__fmul_rn(box.w, L.scale), y1), 1.0f);
    const float bin_w = __fdiv_rn(roi_w, (float)p);
    const float bin_h = __fdiv_rn(roi_h, (float)p);
    float acc = 0.0f;
    for (int iy = 0; iy < s; ++iy) {
      const float gy = __fdiv_rn(__fadd_rn((float)(ph * s + iy), 0.5f), (float)s);
      Axis ay;
      if (!sample_axis(__fadd_rn(y1, __fmul_rn(gy, bin_h)), L.h, &ay)) continue;
      const T* row_lo = f + (size_t)ay.lo * L.w * c;
      const T* row_hi = f + (size_t)ay.hi * L.w * c;
      for (int ix = 0; ix < s; ++ix) {
        const float gx =
            __fdiv_rn(__fadd_rn((float)(pw * s + ix), 0.5f), (float)s);
        Axis ax;
        if (!sample_axis(__fadd_rn(x1, __fmul_rn(gx, bin_w)), L.w, &ax)) continue;
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
  if (num_levels < 1 || num_levels > kMaxLevels) {
    return (int)cudaErrorInvalidValue;
  }
  Pyramid pyr;
  pyr.num_levels = num_levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    const int j = i < num_levels ? i : num_levels - 1;
    pyr.lv[i].data = ((const void* const*)data)[j];
    pyr.lv[i].h = ((const int*)heights)[j];
    pyr.lv[i].w = ((const int*)widths)[j];
    pyr.lv[i].scale = ((const float*)scales)[j];
  }
  const long long total = (long long)n * p * p * c;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < (1LL << 20) ? want : (1LL << 20));
  roi_align_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
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
