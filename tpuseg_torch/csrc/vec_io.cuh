// Channels moved in vectors of 16, 8, 4 or 2 bytes, f32 or bf16 elements
// held as raw 32-bit words, and added into f32 gradients by vector
// reductions: shared by the kernels that give each lane a vector of
// channels (dcn_sample.cu, dcn_sample_bwd.cu, roi_align.cu,
// roi_align_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace tpuseg_vec {

// One feature element as raw bits: its value in f32 and back (bf16 rounds
// to nearest even).
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
// stores (the kernels do not read their outputs again).
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

// The 32-bit words that hold VEC elements of type T.
template <typename T, int VEC>
__host__ __device__ constexpr int words() {
  return VEC * (int)sizeof(T) >= 4 ? VEC * (int)sizeof(T) / 4 : 1;
}

// Element e of packed elements of type T in 32-bit words, in f32.
template <typename T>
__device__ __forceinline__ float unpack(const uint32_t* w, int e) {
  if (sizeof(T) == 4) return Elem<T>::get(w[e]);
  return Elem<T>::get((w[e >> 1] >> (16 * (e & 1))) & 0xffffu);
}

// VEC elements of type T at p (aligned to their size) -> f32 values.
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* p, float* v) {
  uint32_t w[words<T, VEC>()];
  Raw<VEC * (int)sizeof(T)>::load(p, w);
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = unpack<T>(w, e);
}

// VEC f32 values -> VEC elements of type T at p (one rounding each).
template <typename T, int VEC>
__device__ __forceinline__ void store_f32(T* p, const float* v) {
  uint32_t w[words<T, VEC>()];
#pragma unroll
  for (int i = 0; i < words<T, VEC>(); ++i) w[i] = 0u;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const uint32_t bits = Elem<T>::put(v[e]);
    if (sizeof(T) == 4) {
      w[e] = bits;
    } else {
      w[e >> 1] |= bits << (16 * (e & 1));
    }
  }
  Raw<VEC * (int)sizeof(T)>::store(p, w);
}

// Add VEC (4, 2 or 1) f32 values into p (aligned to 4 * VEC bytes) with
// one vector reduction: sm_90's atomicAdd on float4 and float2.
template <int VEC>
__device__ __forceinline__ void red_add(float* p, const float* v) {
  if constexpr (VEC == 4) {
    atomicAdd((float4*)p, make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VEC == 2) {
    atomicAdd((float2*)p, make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// Host side: the widest of 16, 8, 4 and 2 bytes that divides a row of
// `row_bytes` and every pointer; else one element of `itemsize` bytes.
inline int widest_vector(int row_bytes, int itemsize,
                         std::initializer_list<const void*> ptrs) {
  for (int bytes = 16; bytes > itemsize; bytes >>= 1) {
    bool ok = row_bytes % bytes == 0;
    for (const void* p : ptrs) ok = ok && (uintptr_t)p % bytes == 0;
    if (ok) return bytes;
  }
  return itemsize;
}

}  // namespace tpuseg_vec
