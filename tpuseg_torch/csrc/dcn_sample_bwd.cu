// Backward of the DCN point sampler (dcn_sample.cu): the gradients of the
// features, the sample coordinates and the modulation from the gradient of
// the sampled values.
//
// Replaces: tpuseg/ops/pallas/dcn_pl.py::_win_bwd_call (K4c, the Pallas
// kernel _make_win_bwd_kernel, the VJP _dsw_bwd of the windowed sampler) and
// the jnp VJP of the dense path (dcn_pl.py::_bwd). Both differentiate the
// hat-matrix form max(0, 1 - |t - e|) of the sampler; this kernel
// differentiates the port's sampler as the JAX package's gather path
// (ops/sampling.py::_bilinear_corners_zeropad) does, with y0 = floor(y) and
// the weights' derivatives one-sided at integer coordinates, as upstream
// DCNv2's CUDA backward. The two rules differ only where a coordinate is an
// integer (there the hat's sub-gradient of |.| takes another side).
//
// For each sample (b, s) with the forward's corners, weights and inside-map
// test (no coordinate clamping), and g = grad[b, s, :]:
//   d feats[b, corner, c] += (g[c] * m) * w_corner
//   d sy = m * sum_c g[c] * (-hx f00 - lx f01 + hx f10 + lx f11)
//   d sx = m * sum_c g[c] * (-hy f00 + hy f01 - ly f10 + ly f11)
//   d m  = sum_c g[c] * (w00 f00 + w01 f01 + w10 f10 + w11 f11)
// with a corner outside the map read as 0 and given nothing.
//
// What bounds it on this card: the scattered adds. At the layer2 geometry
// of YOLACT++-550 R-50 (69x69x128, stride 1, B = 8: S = 42 849 samples per
// image) the function adds 175.5 M floats into a 19.5 MB gradient buffer
// that stays in the 50 MB L2, where the atomics resolve, against ~220 MB
// of bytes it must move (the [B, S, C] gradient and the touched feature
// cells read, the gradient buffer written) and ~1.5 G f32 operations. The
// first design (one warp per sample, lanes striding over the channels one
// scalar at a time) issued them as 175.5 M scalar atomicAdds (0.44 ms; bf16
// no faster). This one issues 44 M float4 reductions: measured on an H100
// 80GB HBM3 at 700 W, d feats alone takes 0.26 ms of 0.30 in f32, ~2.7
// TB/s of added floats, the coordinate sums alone 0.20 (the corners'
// reads). Summing a run of 256 samples' adds in a shared-memory window
// first (the TPU kernel's d_map window) measured 0.58 ms: shared f32
// atomics and the window's flush cost more than the L2's adds they
// saved with these samples (offsets of ~2 px), and at the small maps
// (S = 2 916) too few blocks were left to fill the card.
//
// Design: dcn_sample.cu's structure, with vector reductions into d feats.
//  * A group of `lanes` threads (a power of two, at most a warp) takes one
//    sample; a 256-thread block takes 256 / lanes samples of one image. The
//    image comes from blockIdx.y, the sample from blockIdx.x: no division.
//  * Each lane computes the sample's coordinates, floor, four weights,
//    inside tests and corner offsets once, then walks its channels VEC at a
//    time: one VEC-wide load of the gradient, and per inside corner one
//    vector reduction of (g * m) * w into the f32 buffer (sm_90's
//    atomicAdd on float4 / float2: red.global.add.v4.f32, one instruction
//    for four channels, so 44 M instead of 176 M at the geometry above);
//    for the coordinate sums four VEC-wide corner loads and f32 arithmetic
//    per channel.
//  * VEC is the widest vector of at most four channels (16 bytes of f32, 8
//    of bf16) that divides the row (C x itemsize) and the pointers; else
//    one element. The reductions take the same channels in f32: float4,
//    float2 or one float, so a group's reductions into one corner cover
//    one contiguous run of floats. A ragged C (130) or unaligned storage
//    runs the same arithmetic narrower.
//  * The three per-sample sums over C are taken per lane in f32, then over
//    the group's lanes by butterfly shuffles, and written by its lane 0.
// The TPU kernel keeps a per-image d_map in VMEM and adds each tile's
// window into it with a read-modify-write that relies on the grid running
// in order; here blocks run in no order, so the adds are atomic, into a
// zeroed channels-last f32 buffer [B, H, W, C] that the wrapper allocates
// and casts once to the feature dtype (as roi_align_bwd.cu). Features and
// gradient in f32 or bf16, all arithmetic in f32. The order of the atomic
// adds and of the sums over C differs from the plain version
// (tpuseg_torch/ops/sampling.py::sample_points_backward_plain): the two
// agree to rounding, not bit for bit. A null gradient pointer skips that
// gradient: d feats (dfeats), the coordinates and the modulation (dsy;
// dsx and dm go with it), the modulation alone (dm). Offsets inside one
// image are 32-bit (the wrapper requires H*W*C and S*C below 2^31).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using namespace tpuseg_vec;

constexpr int kThreads = 256;

// Sum over the `lanes` lanes of each group (aligned, a power of two); every
// lane of the warp takes part.
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    dcn_sample_bwd_kernel(const T* __restrict__ feats,
                          const float* __restrict__ sy,
                          const float* __restrict__ sx,
                          const float* __restrict__ m,
                          const T* __restrict__ grad, int h, int w, int c,
                          int s, int lanes_log2, float* __restrict__ dfeats,
                          float* __restrict__ dsy, float* __restrict__ dsx,
                          float* __restrict__ dm) {
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int sample =
      blockIdx.x * (kThreads >> lanes_log2) + (threadIdx.x >> lanes_log2);
  // no early return: the group sums below shuffle over whole warps
  const bool live = sample < s;
  const size_t bs = (size_t)blockIdx.y * s + (live ? sample : 0);
  const size_t image = (size_t)blockIdx.y * h * w * c;

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
  // map is read as 0 and given nothing
  bool in[4];
  float wt[4];
  int off[4];
  in[0] = in_y0 && in_x0;
  in[1] = in_y0 && in_x1;
  in[2] = in_y1 && in_x0;
  in[3] = in_y1 && in_x1;
  wt[0] = __fmul_rn(hy, hx);
  wt[1] = __fmul_rn(hy, lx);
  wt[2] = __fmul_rn(ly, hx);
  wt[3] = __fmul_rn(ly, lx);
  const int r0 = in_y0 ? (int)y0 * w : 0, r1 = in_y1 ? (int)y1 * w : 0;
  const int c0 = in_x0 ? (int)x0 : 0, c1 = in_x1 ? (int)x1 : 0;
  off[0] = (r0 + c0) * c;
  off[1] = (r0 + c1) * c;
  off[2] = (r1 + c0) * c;
  off[3] = (r1 + c1) * c;
  const float mod = m != nullptr ? m[bs] : 1.0f;
  const T* f = feats + image;
  const T* g_row = grad + bs * c;
  float* df = dfeats != nullptr ? dfeats + image : nullptr;

  float acc_y = 0.0f, acc_x = 0.0f, acc_m = 0.0f;
  if (live && (in[0] || in[1] || in[2] || in[3])) {  // else all zero
    for (int ch = lane * VEC; ch < c; ch += lanes * VEC) {
      float g[VEC];
      load_f32<T, VEC>(g_row + ch, g);
      if (df != nullptr) {
        float gm[VEC], add[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          gm[e] = m != nullptr ? __fmul_rn(g[e], mod) : g[e];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!in[k]) continue;
#pragma unroll
          for (int e = 0; e < VEC; ++e) add[e] = __fmul_rn(gm[e], wt[k]);
          red_add<VEC>(df + off[k] + ch, add);
        }
      }
      if (dsy != nullptr) {
        float v[4][VEC];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (in[k]) {
            load_f32<T, VEC>(f + off[k] + ch, v[k]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[k][e] = 0.0f;
          }
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f00 = v[0][e], f01 = v[1][e], f10 = v[2][e],
                      f11 = v[3][e];
          float ty = __fsub_rn(-__fmul_rn(hx, f00), __fmul_rn(lx, f01));
          ty = __fadd_rn(ty, __fmul_rn(hx, f10));
          ty = __fadd_rn(ty, __fmul_rn(lx, f11));
          float tx = __fadd_rn(-__fmul_rn(hy, f00), __fmul_rn(hy, f01));
          tx = __fsub_rn(tx, __fmul_rn(ly, f10));
          tx = __fadd_rn(tx, __fmul_rn(ly, f11));
          float val = __fadd_rn(__fmul_rn(f00, wt[0]), __fmul_rn(f01, wt[1]));
          val = __fadd_rn(val, __fmul_rn(f10, wt[2]));
          val = __fadd_rn(val, __fmul_rn(f11, wt[3]));
          acc_y = __fadd_rn(acc_y, __fmul_rn(g[e], ty));
          acc_x = __fadd_rn(acc_x, __fmul_rn(g[e], tx));
          acc_m = __fadd_rn(acc_m, __fmul_rn(g[e], val));
        }
      }
    }
  }
  if (dsy != nullptr) {  // grid-uniform: every lane reaches the shuffles
    acc_y = group_sum(acc_y, lanes);
    acc_x = group_sum(acc_x, lanes);
    acc_m = group_sum(acc_m, lanes);
    if (live && lane == 0) {
      dsy[bs] = __fmul_rn(acc_y, mod);
      dsx[bs] = __fmul_rn(acc_x, mod);
      if (dm != nullptr) dm[bs] = acc_m;
    }
  }
}

template <typename T, int VEC>
int launch_vec(const void* feats, const void* sy, const void* sx,
               const void* m, const void* grad, int batch, int h, int w,
               int c, int s, void* dfeats, void* dsy, void* dsx, void* dm,
               cudaStream_t stream) {
  // lanes per sample: the smallest power of two that covers the row's
  // vectors, at most a warp (wider rows loop)
  const int vectors = c / VEC;
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (1 << lanes_log2) < vectors) ++lanes_log2;
  const int per_block = kThreads >> lanes_log2;
  const dim3 grid((s + per_block - 1) / per_block, batch);
  dcn_sample_bwd_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      (const T*)feats, (const float*)sy, (const float*)sx, (const float*)m,
      (const T*)grad, h, w, c, s, lanes_log2, (float*)dfeats, (float*)dsy,
      (float*)dsx, (float*)dm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* feats, const void* sy, const void* sx,
               const void* m, const void* grad, int batch, int h, int w,
               int c, int s, void* dfeats, void* dsy, void* dsx, void* dm,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // the widest vector of at most four channels that divides the row, the
  // features and the gradient: a lane's reduction is then at most one
  // float4, and neighbouring lanes add into neighbouring floats (eight bf16
  // channels a lane would make two float4s that each fill half of every
  // 32-byte sector they touch)
  const int item = (int)sizeof(T);
  switch (widest_vector(c * item, item, {feats, grad, dfeats}) / item) {
    case 8:
    case 4:
      return launch_vec<T, 4>(feats, sy, sx, m, grad, batch, h, w, c, s,
                              dfeats, dsy, dsx, dm, st);
    case 2:
      return launch_vec<T, 2>(feats, sy, sx, m, grad, batch, h, w, c, s,
                              dfeats, dsy, dsx, dm, st);
    default:
      return launch_vec<T, 1>(feats, sy, sx, m, grad, batch, h, w, c, s,
                              dfeats, dsy, dsx, dm, st);
  }
}

}  // namespace

// feats [B, H, W, C] (channels-last) in f32 or bf16; sy, sx [B, S] f32;
// m [B, S] f32 or null (no modulation); grad [B, S, C] in the feature dtype.
// dfeats: zeroed f32 [B, H, W, C], added into, or null; dsy, dsx [B, S] f32
// (both or neither); dm [B, S] f32 or null (null when m is). Requires
// B * S >= 1, B <= 65535, H * W * C < 2^31 and S * C < 2^31.
extern "C" int tpuseg_dcn_sample_bwd_f32(const void* feats, const void* sy,
                                         const void* sx, const void* m,
                                         const void* grad, int batch, int h,
                                         int w, int c, int s, void* dfeats,
                                         void* dsy, void* dsx, void* dm,
                                         void* stream) {
  return launch_bwd<float>(feats, sy, sx, m, grad, batch, h, w, c, s, dfeats,
                           dsy, dsx, dm, stream);
}

extern "C" int tpuseg_dcn_sample_bwd_bf16(const void* feats, const void* sy,
                                          const void* sx, const void* m,
                                          const void* grad, int batch, int h,
                                          int w, int c, int s, void* dfeats,
                                          void* dsy, void* dsx, void* dm,
                                          void* stream) {
  return launch_bwd<__nv_bfloat16>(feats, sy, sx, m, grad, batch, h, w, c, s,
                                   dfeats, dsy, dsx, dm, stream);
}
