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
// What bounds it on this card: bytes, once the instructions are few. The
// [B, S, C] output is written once (175 MB in f32 at YOLACT++-550 R-50's
// layer2 geometry, 69x69x128, B = 8); the corners come from the 50 MB L2,
// which holds the maps (<= 2.4 MB per image in f32). Paid once per channel,
// the per-sample work (the sample's index, coordinates, floor, four weights,
// four inside tests) costs ~250 instructions a value, and instruction issue,
// not bytes, sets the pace (bf16 then runs no faster than f32).
//
// Design: one group of lanes per sample, a vector of channels per lane.
//  * A group of `lanes` threads (a power of two, at most a warp) takes one
//    sample; a 256-thread block takes 256 / lanes samples of one image. The
//    image comes from blockIdx.y, the sample from blockIdx.x: no division.
//  * Each lane computes the sample's coordinates, floor, the four weights
//    and inside tests and the four corner offsets once, then walks its
//    channels VEC at a time: four VEC-wide corner loads (16 bytes when the
//    channel count and the pointers allow: float4, eight bf16), f32
//    arithmetic per channel, one VEC-wide streaming store. Neighbouring
//    lanes touch neighbouring addresses.
//  * VEC is the widest of 16, 8, 4 and 2 bytes that divides the row
//    (C x itemsize) and both pointers; else one element: a ragged C (3, 130)
//    or a feature tensor whose storage is not 16-byte aligned takes the
//    narrower path with the same arithmetic.
//  * Offsets inside one image are 32-bit (the wrapper requires H*W*C and
//    S*C below 2^31).
// Every step is an IEEE-rounded intrinsic (no FMA contraction) in the order
// of the plain version (tpuseg_torch/ops/sampling.py::sample_points_plain):
// the weights are hoisted out of the channel loop, which changes no
// rounding, so the two are equal bit for bit, in f32 and in bf16 (the f32
// sum rounded once to the feature dtype).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One feature element as raw bits: its value in f32 and back.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float get(uint32_t bits) {
    return __uint_as_float(bits);
  }
  static __device__ __forceinline__ uint32_t put(float v) {
    return __float_as_uint(v);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float get(uint32_t bits) {
    return __uint_as_float(bits << 16);
  }
  static __device__ __forceinline__ uint32_t put(float v) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v));
  }
};

// BYTES of contiguous memory as 32-bit words (a 2-byte load fills the low
// half of word 0), read through the read-only path or written as streaming
// stores (the output is not read again by this kernel).
template <int BYTES>
struct Raw;
template <>
struct Raw<16> {
  static __device__ __forceinline__ void load(const void* p, uint32_t* w) {
    const uint4 v = __ldg((const uint4*)p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
  static __device__ __forceinline__ void store(void* p, const uint32_t* w) {
    __stcs((uint4*)p, make_uint4(w[0], w[1], w[2], w[3]));
  }
};
template <>
struct Raw<8> {
  static __device__ __forceinline__ void load(const void* p, uint32_t* w) {
    const uint2 v = __ldg((const uint2*)p);
    w[0] = v.x, w[1] = v.y;
  }
  static __device__ __forceinline__ void store(void* p, const uint32_t* w) {
    __stcs((uint2*)p, make_uint2(w[0], w[1]));
  }
};
template <>
struct Raw<4> {
  static __device__ __forceinline__ void load(const void* p, uint32_t* w) {
    w[0] = __ldg((const unsigned int*)p);
  }
  static __device__ __forceinline__ void store(void* p, const uint32_t* w) {
    __stcs((unsigned int*)p, w[0]);
  }
};
template <>
struct Raw<2> {
  static __device__ __forceinline__ void load(const void* p, uint32_t* w) {
    w[0] = __ldg((const unsigned short*)p);
  }
  static __device__ __forceinline__ void store(void* p, const uint32_t* w) {
    __stcs((unsigned short*)p, (unsigned short)w[0]);
  }
};

// element e of VEC packed elements of type T in 32-bit words
template <typename T>
__device__ __forceinline__ float unpack(const uint32_t* w, int e) {
  if (sizeof(T) == 4) return Elem<T>::get(w[e]);
  return Elem<T>::get((w[e >> 1] >> (16 * (e & 1))) & 0xffffu);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    dcn_sample_kernel(const T* __restrict__ feats,
                      const float* __restrict__ sy,
                      const float* __restrict__ sx,
                      const float* __restrict__ m, int h, int w, int c, int s,
                      int lanes_log2, T* __restrict__ out) {
  constexpr int kBytes = VEC * (int)sizeof(T);
  constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int sample =
      blockIdx.x * (kThreads >> lanes_log2) + (threadIdx.x >> lanes_log2);
  if (sample >= s) return;
  const size_t bs = (size_t)blockIdx.y * s + sample;
  const T* f = feats + (size_t)blockIdx.y * h * w * c;
  T* o = out + bs * c;

  // the per-sample work, once per lane
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
  const float hmax = (float)(h - 1), wmax = (float)(w - 1);
  const bool in_y0 = y0 >= 0.0f && y0 <= hmax;
  const bool in_y1 = y1 >= 0.0f && y1 <= hmax;
  const bool in_x0 = x0 >= 0.0f && x0 <= wmax;
  const bool in_x1 = x1 >= 0.0f && x1 <= wmax;
  // corner k: (y0, x0), (y0, x1), (y1, x0), (y1, x1); a corner outside the
  // map reads nothing and adds 0 * 0 = +0
  bool in[4];
  float wt[4];
  int off[4];
  in[0] = in_y0 && in_x0;
  in[1] = in_y0 && in_x1;
  in[2] = in_y1 && in_x0;
  in[3] = in_y1 && in_x1;
  wt[0] = in[0] ? __fmul_rn(hy, hx) : 0.0f;
  wt[1] = in[1] ? __fmul_rn(hy, lx) : 0.0f;
  wt[2] = in[2] ? __fmul_rn(ly, hx) : 0.0f;
  wt[3] = in[3] ? __fmul_rn(ly, lx) : 0.0f;
  const int r0 = in_y0 ? (int)y0 * w : 0, r1 = in_y1 ? (int)y1 * w : 0;
  const int c0 = in_x0 ? (int)x0 : 0, c1 = in_x1 ? (int)x1 : 0;
  off[0] = (r0 + c0) * c;
  off[1] = (r0 + c1) * c;
  off[2] = (r1 + c0) * c;
  off[3] = (r1 + c1) * c;
  const float mod = m != nullptr ? m[bs] : 1.0f;

  for (int ch = lane * VEC; ch < c; ch += lanes * VEC) {
    uint32_t raw[4][kWords];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (in[k]) {
        Raw<kBytes>::load(f + off[k] + ch, raw[k]);
      } else {
#pragma unroll
        for (int i = 0; i < kWords; ++i) raw[k][i] = 0u;
      }
    }
    uint32_t res[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) res[i] = 0u;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float acc = __fadd_rn(__fmul_rn(unpack<T>(raw[0], e), wt[0]),
                            __fmul_rn(unpack<T>(raw[1], e), wt[1]));
      acc = __fadd_rn(acc, __fmul_rn(unpack<T>(raw[2], e), wt[2]));
      acc = __fadd_rn(acc, __fmul_rn(unpack<T>(raw[3], e), wt[3]));
      if (m != nullptr) acc = __fmul_rn(acc, mod);
      const uint32_t bits = Elem<T>::put(acc);
      if (sizeof(T) == 4) {
        res[e] = bits;
      } else {
        res[e >> 1] |= bits << (16 * (e & 1));
      }
    }
    Raw<kBytes>::store(o + ch, res);
  }
}

// The widest vector (in elements) that divides the row and both pointers.
template <typename T>
int pick_vec(const void* feats, const void* out, int c) {
  const int row = c * (int)sizeof(T);
  for (int bytes = 16; bytes > (int)sizeof(T); bytes >>= 1) {
    if (row % bytes == 0 && (uintptr_t)feats % bytes == 0 &&
        (uintptr_t)out % bytes == 0) {
      return bytes / (int)sizeof(T);
    }
  }
  return 1;
}

template <typename T, int VEC>
int launch_vec(const void* feats, const void* sy, const void* sx,
               const void* m, int batch, int h, int w, int c, int s, void* out,
               cudaStream_t stream) {
  // lanes per sample: the smallest power of two that covers the row's
  // vectors, at most a warp (wider rows loop)
  const int vectors = c / VEC;
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (1 << lanes_log2) < vectors) ++lanes_log2;
  const int per_block = kThreads >> lanes_log2;
  const dim3 grid((s + per_block - 1) / per_block, batch);
  dcn_sample_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      (const T*)feats, (const float*)sy, (const float*)sx, (const float*)m, h,
      w, c, s, lanes_log2, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* feats, const void* sy, const void* sx, const void* m,
           int batch, int h, int w, int c, int s, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (pick_vec<T>(feats, out, c) * (int)sizeof(T)) {
    case 16:
      return launch_vec<T, (int)(16 / sizeof(T))>(feats, sy, sx, m, batch, h, w, c,
                                            s, out, st);
    case 8:
      return launch_vec<T, (int)(8 / sizeof(T))>(feats, sy, sx, m, batch, h, w, c, s,
                                           out, st);
    case 4:
      return launch_vec<T, (int)(4 / sizeof(T))>(feats, sy, sx, m, batch, h, w, c, s,
                                           out, st);
    default:
      return launch_vec<T, 1>(feats, sy, sx, m, batch, h, w, c, s, out, st);
  }
}

}  // namespace

// feats [B, H, W, C] (channels-last) in f32 or bf16; sy, sx [B, S] f32;
// m [B, S] f32 or null (no modulation); out [B, S, C] in the feature dtype.
// Requires B * S * C >= 1, B <= 65535, H * W * C < 2^31 and S * C < 2^31.
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
