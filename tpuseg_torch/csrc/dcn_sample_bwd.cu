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
// image) it makes 176 M f32 atomicAdds into a 19.5 MB gradient buffer that
// stays in the 50 MB L2, where the atomics resolve, against ~220 MB of
// bytes it must move (the [B, S, C] gradient and the touched feature cells
// read, the gradient buffer written) and ~1.5 G f32 operations.
//
// Design, the simple one. The TPU kernel keeps a per-image d_map in VMEM
// and adds each tile's window into it with a read-modify-write that relies
// on the grid running in order; here blocks run in no order, so the adds are
// f32 atomicAdds into a zeroed channels-last f32 buffer [B, H, W, C] that
// the wrapper allocates and casts once to the feature dtype (as
// roi_align_bwd.cu). One warp takes one sample; its lanes stride over the
// channels, so neighbouring lanes add into neighbouring floats of each
// corner (one 128-byte line per 32 channels in f32) and read neighbouring
// values of the gradient and of the corners. The three per-sample sums over
// C are taken per lane in f32, then by a warp shuffle, and written by lane
// 0. Features and gradient in f32 or bf16, all arithmetic in f32. The order
// of the atomic adds and of the sums over C differs from the plain version
// (tpuseg_torch/ops/sampling.py::sample_points_backward_plain): the two
// agree to rounding, not bit for bit. A null gradient pointer skips that
// gradient: d feats (dfeats), the coordinates and the modulation (dsy;
// dsx and dm go with it), the modulation alone (dm).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ bool inside(float row, float col, int h, int w) {
  return row >= 0.0f && row <= (float)(h - 1) && col >= 0.0f &&
         col <= (float)(w - 1);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__global__ void dcn_sample_bwd_kernel(
    const T* __restrict__ feats, const float* __restrict__ sy,
    const float* __restrict__ sx, const float* __restrict__ m,
    const T* __restrict__ grad, int h, int w, int c, long long s,
    long long total, float* __restrict__ dfeats, float* __restrict__ dsy,
    float* __restrict__ dsx, float* __restrict__ dm) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long bs = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
       bs < total; bs += nwarps) {  // bs = b * S + sample, one per warp
    const size_t image = (size_t)(bs / s) * h * w * c;
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
    const bool i00 = inside(y0, x0, h, w), i01 = inside(y0, x1, h, w);
    const bool i10 = inside(y1, x0, h, w), i11 = inside(y1, x1, h, w);
    if (!(i00 || i01 || i10 || i11)) {  // wholly outside: all zero
      if (lane == 0 && dsy != nullptr) {
        dsy[bs] = 0.0f;
        dsx[bs] = 0.0f;
        if (dm != nullptr) dm[bs] = 0.0f;
      }
      continue;
    }
    const float w00 = __fmul_rn(hy, hx), w01 = __fmul_rn(hy, lx);
    const float w10 = __fmul_rn(ly, hx), w11 = __fmul_rn(ly, lx);
    // corner offsets, read only where the corner is inside
    const size_t o00 = i00 ? ((size_t)y0 * w + (size_t)x0) * c : 0;
    const size_t o01 = i01 ? ((size_t)y0 * w + (size_t)x1) * c : 0;
    const size_t o10 = i10 ? ((size_t)y1 * w + (size_t)x0) * c : 0;
    const size_t o11 = i11 ? ((size_t)y1 * w + (size_t)x1) * c : 0;
    const float mod = m != nullptr ? m[bs] : 1.0f;
    const T* f = feats + image;
    const T* g_row = grad + (size_t)bs * c;
    float* df = dfeats != nullptr ? dfeats + image : nullptr;
    float acc_y = 0.0f, acc_x = 0.0f, acc_m = 0.0f;
    for (int ch = lane; ch < c; ch += 32) {
      const float g = to_f32(g_row[ch]);
      if (df != nullptr) {
        const float gm = m != nullptr ? __fmul_rn(g, mod) : g;
        if (gm != 0.0f) {
          if (i00) atomicAdd(df + o00 + ch, __fmul_rn(gm, w00));
          if (i01) atomicAdd(df + o01 + ch, __fmul_rn(gm, w01));
          if (i10) atomicAdd(df + o10 + ch, __fmul_rn(gm, w10));
          if (i11) atomicAdd(df + o11 + ch, __fmul_rn(gm, w11));
        }
      }
      if (dsy != nullptr) {
        const float f00 = i00 ? to_f32(f[o00 + ch]) : 0.0f;
        const float f01 = i01 ? to_f32(f[o01 + ch]) : 0.0f;
        const float f10 = i10 ? to_f32(f[o10 + ch]) : 0.0f;
        const float f11 = i11 ? to_f32(f[o11 + ch]) : 0.0f;
        float ty = __fsub_rn(-__fmul_rn(hx, f00), __fmul_rn(lx, f01));
        ty = __fadd_rn(ty, __fmul_rn(hx, f10));
        ty = __fadd_rn(ty, __fmul_rn(lx, f11));
        float tx = __fadd_rn(-__fmul_rn(hy, f00), __fmul_rn(hy, f01));
        tx = __fsub_rn(tx, __fmul_rn(ly, f10));
        tx = __fadd_rn(tx, __fmul_rn(ly, f11));
        float v = __fadd_rn(__fmul_rn(f00, w00), __fmul_rn(f01, w01));
        v = __fadd_rn(v, __fmul_rn(f10, w10));
        v = __fadd_rn(v, __fmul_rn(f11, w11));
        acc_y = __fadd_rn(acc_y, __fmul_rn(g, ty));
        acc_x = __fadd_rn(acc_x, __fmul_rn(g, tx));
        acc_m = __fadd_rn(acc_m, __fmul_rn(g, v));
      }
    }
    if (dsy != nullptr) {  // warp-uniform: every lane reaches the shuffles
      acc_y = warp_sum(acc_y);
      acc_x = warp_sum(acc_x);
      acc_m = warp_sum(acc_m);
      if (lane == 0) {
        dsy[bs] = __fmul_rn(acc_y, mod);
        dsx[bs] = __fmul_rn(acc_x, mod);
        if (dm != nullptr) dm[bs] = acc_m;
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* feats, const void* sy, const void* sx,
               const void* m, const void* grad, int batch, int h, int w,
               int c, int s, void* dfeats, void* dsy, void* dsx, void* dm,
               void* stream) {
  const long long total = (long long)batch * s;  // one warp per sample
  const int threads = 256;
  const long long want = (total * 32 + threads - 1) / threads;
  const int blocks = (int)(want < (1LL << 20) ? want : (1LL << 20));
  dcn_sample_bwd_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)feats, (const float*)sy, (const float*)sx, (const float*)m,
      (const T*)grad, h, w, c, (long long)s, total, (float*)dfeats,
      (float*)dsy, (float*)dsx, (float*)dm);
  return (int)cudaGetLastError();
}

}  // namespace

// feats [B, H, W, C] (channels-last) in f32 or bf16; sy, sx [B, S] f32;
// m [B, S] f32 or null (no modulation); grad [B, S, C] in the feature dtype.
// dfeats: zeroed f32 [B, H, W, C], added into, or null; dsy, dsx [B, S] f32
// (both or neither); dm [B, S] f32 or null (null when m is). Requires
// B * S >= 1.
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
