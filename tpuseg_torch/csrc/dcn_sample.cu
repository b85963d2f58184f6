// Bilinear point sampling with zero padding: DCNv2's sampler.
//
// Replaces: tpuseg/ops/pallas/dcn_pl.py::_dcn_sample_pallas (the dense
// hat-matrix kernel, K4a) and ::_win_call (the windowed one, K4b). On the
// program's path both compute one function: their row and column weights
// are always hat_matrix(coordinates) (deform_conv.py:127-129,261-264;
// sampling.py:719-723), so each sample is the zero-padded bilinear value of
// the map at (sy, sx), times the modulation. The two TPU kernels differ only
// in how they lay that out in VMEM (the whole map, or a 32-row window per
// tile with 8-aligned origins and an exact correction for samples that
// escape it), which this card does not need: its caches serve the reuse
// between neighbouring samples. This kernel computes the function.
//
// out[b, s, c] = m[b, s] * sum over the corners (y0, x0), (y0, x1),
// (y1, x0), (y1, x1) of w * feats[b, corner, c], with y0 = floor(sy),
// ly = sy - y0, hy = 1 - ly (x likewise), the weights hy*hx, hy*lx, ly*hx,
// ly*lx, and a corner outside [0, H-1] x [0, W-1] weighted 0 (no coordinate
// clamping: ops/sampling.py::_bilinear_corners_zeropad in the JAX package).
//
// What bounds it on this card: memory access. Each output value reads four
// corner values at data-dependent rows and columns and does about a dozen
// f32 operations with them; the map of one image (<= 2.4 MB in f32 for
// YOLACT++-550) fits the 50 MB L2, so the corners that neighbouring samples
// share come from the cache.
//
// Design, the simple one: one thread per output value (b, s, c), the
// channel fastest, over channels-last features [B, H, W, C]. The 32 threads
// of a warp read 32 consecutive channels of each corner (one 128-byte line
// in f32) and write 32 consecutive outputs. The coordinates of a sample are
// read by each of its C threads (a broadcast within the warp). Offsets are
// 64-bit. The sum is f32 for f32 and bf16 features and is rounded once to
// the feature dtype. Every step is an IEEE-rounded intrinsic (no FMA
// contraction) in the order of the plain version
// (tpuseg_torch/ops/sampling.py::sample_points_plain), so the two are equal
// bit for bit, in f32 and in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// w * feats[row, col] when the corner lies inside the map, else 0.
template <typename T>
__device__ __forceinline__ float corner(const T* f, float row, float col,
                                        float wy, float wx, int h, int w,
                                        int c) {
  if (!(row >= 0.0f && row <= (float)(h - 1) && col >= 0.0f &&
        col <= (float)(w - 1))) {
    return 0.0f;
  }
  const float v = to_f32(f[((size_t)row * w + (size_t)col) * c]);
  return __fmul_rn(v, __fmul_rn(wy, wx));
}

template <typename T>
__global__ void dcn_sample_kernel(const T* __restrict__ feats,
                                  const float* __restrict__ sy,
                                  const float* __restrict__ sx,
                                  const float* __restrict__ m, int h, int w,
                                  int c, long long s, long long total,
                                  T* __restrict__ out) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long bs = idx / c;  // b * S + sample
    const int ch = (int)(idx - bs * c);
    const T* f = feats + (size_t)(bs / s) * h * w * c + ch;
    const float y = sy[bs];
    const float x = sx[bs];
    const float y0 = floorf(y);
    const float x0 = floorf(x);
    const float ly = __fsub_rn(y, y0);
    const float lx = __fsub_rn(x, x0);
    const float hy = __fsub_rn(1.0f, ly);
    const float hx = __fsub_rn(1.0f, lx);
    const float y1 = __fadd_rn(y0, 1.0f);
    const float x1 = __fadd_rn(x0, 1.0f);
    float acc = __fadd_rn(corner(f, y0, x0, hy, hx, h, w, c),
                          corner(f, y0, x1, hy, lx, h, w, c));
    acc = __fadd_rn(acc, corner(f, y1, x0, ly, hx, h, w, c));
    acc = __fadd_rn(acc, corner(f, y1, x1, ly, lx, h, w, c));
    if (m != nullptr) acc = __fmul_rn(acc, m[bs]);
    out[idx] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* feats, const void* sy, const void* sx, const void* m,
           int batch, int h, int w, int c, int s, void* out, void* stream) {
  const long long total = (long long)batch * s * c;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < (1LL << 20) ? want : (1LL << 20));
  dcn_sample_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)feats, (const float*)sy, (const float*)sx, (const float*)m, h,
      w, c, (long long)s, total, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// feats [B, H, W, C] (channels-last) in f32 or bf16; sy, sx [B, S] f32;
// m [B, S] f32 or null (no modulation); out [B, S, C] in the feature dtype.
// Requires B * S * C >= 1.
extern "C" int tpuseg_dcn_sample_f32(const void* feats, const void* sy,
                                     const void* sx, const void* m, int batch,
                                     int h, int w, int c, int s, void* out,
                                     void* stream) {
  return launch<float>(feats, sy, sx, m, batch, h, w, c, s, out, stream);
}

extern "C" int tpuseg_dcn_sample_bf16(const void* feats, const void* sy,
                                      const void* sx, const void* m, int batch,
                                      int h, int w, int c, int s, void* out,
                                      void* stream) {
  return launch<__nv_bfloat16>(feats, sy, sx, m, batch, h, w, c, s, out,
                               stream);
}
