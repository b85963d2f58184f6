// The R-CNN predictors' canvas: each BGR uint8 frame resized as Pillow's
// BILINEAR resize of 8-bit bands, normalised in f32 and padded with zeros
// into the f32 [B, 3, Hc, Wc] canvas, in one kernel.
//
// Replaces no TPU kernel. The JAX engine builds the canvas on the host
// (tpuseg/engine/maskrcnn_engine.py::preprocess_image_bgr: PIL resize,
// numpy normalisation, an NCHW copy). The port adds this kernel because
// that host work was about half of a streamed ViTDet request: a 640 x 480
// frame to 1024 x 768 on the 1024 x 1024 canvas, 12.6 MB of f32 made on
// the host and uploaded from pageable memory. Here only the uint8 frame and
// its tap tables cross to the card.
//
// Arithmetic: Pillow's (libImaging/Resample.c), with its coefficients made
// on the host (kernels/canvas.py::resize_taps): per axis and output index a
// first source index, a number of taps and integer weights of 22
// fractional bits. A horizontal sample is
//   clip8(2^21 + sum_i pixel(y, x0 + i) kx_i),
// clip8(v) = min(max(v >> 22, 0), 255), a uint8 as Pillow's intermediate
// image holds it, and the pixel is clip8(2^21 + sum_j hsample(y0 + j) ky_j).
// An axis that keeps its size has one tap of weight 2^22, which gives the
// pixel back, as Pillow's skipped pass does. Then, in f32 rounded as
// written (no contraction), x - mean (BGR) or (x - mean) / std on RGB.
// Integers are exact and the two f32 operations correctly rounded, so the
// canvas equals the host's bit for bit.
//
// What bounds it on this card: bytes, and the write dominates. At the
// ViTDet canvas 1024 x 1024 x 3 f32 = 12.58 MB written and a 640 x 480
// frame (0.92 MB) read: 4.0 us at 3.35 TB/s.
//
// Design: one thread per canvas pixel, all three channels, neighbouring
// threads on neighbouring pixels of a row, so each channel plane is written
// by whole 128-byte warp stores and the padding by the same threads (no
// separate zero fill). Each thread recomputes the horizontal samples of its
// vertical taps from the frame (about two rows of two taps when upscaling),
// reading bytes that its warp's neighbours read too, from L1. Nothing is
// staged in shared memory, so any scale and any frame size run the same
// code: a strip of rows staged per block, as csrc/mask_paste.cu does, would
// bound the vertical scale by shared memory and save only L1 reads, while
// the bytes written are the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBits = 22;
constexpr int kDescWords = 9;

struct Norm {
  float mean[3];
  float std[3];
  int rgb;  // 1: RGB (x - mean) / std; 0: BGR x - mean
};

__device__ __forceinline__ int clip8(int v) {
  return v <= 0 ? 0 : min(v >> kBits, 255);
}

__global__ void __launch_bounds__(kThreads)
    canvas_kernel(const uint8_t* __restrict__ buf, int hc, int wc, Norm norm,
                  float* __restrict__ out) {
  const int b = blockIdx.y;
  const long long plane = (long long)hc * wc;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= plane) return;
  const int r = (int)(p / wc), c = (int)(p - (long long)r * wc);
  // [frame offset, w, th, tw, x taps offset, y taps offset, x taps row
  //  length, y taps row length, 1 if the frame is stored RGB]; th = tw = 0
  //  for a blank canvas
  const long long* d = (const long long*)buf + (long long)kDescWords * b;
  const int th = (int)__ldg(d + 2), tw = (int)__ldg(d + 3);
  float v[3] = {0.0f, 0.0f, 0.0f};
  if (r < th && c < tw) {
    const int w = (int)__ldg(d + 1);
    const uint8_t* frame = buf + __ldg(d + 0);
    const int* xt = (const int*)(buf + __ldg(d + 4)) + c * (int)__ldg(d + 6);
    const int* yt = (const int*)(buf + __ldg(d + 5)) + r * (int)__ldg(d + 7);
    const int x0 = __ldg(xt), nx = __ldg(xt + 1);
    const int y0 = __ldg(yt), ny = __ldg(yt + 1);
    const bool reverse = norm.rgb != (int)__ldg(d + 8);  // output ch <- 2 - ch
    int acc[3] = {1 << (kBits - 1), 1 << (kBits - 1), 1 << (kBits - 1)};
    for (int j = 0; j < ny; ++j) {
      const uint8_t* px = frame + ((long long)(y0 + j) * w + x0) * 3;
      int hs[3] = {1 << (kBits - 1), 1 << (kBits - 1), 1 << (kBits - 1)};
      for (int i = 0; i < nx; ++i) {
        const int k = __ldg(xt + 2 + i);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) hs[ch] += (int)__ldg(px + 3 * i + ch) * k;
      }
      const int k = __ldg(yt + 2 + j);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) acc[ch] += clip8(hs[ch]) * k;
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float x = (float)clip8(acc[reverse ? 2 - ch : ch]);
      const float centred = __fsub_rn(x, norm.mean[ch]);
      v[ch] = norm.rgb ? __fdiv_rn(centred, norm.std[ch]) : centred;
    }
  }
  float* o = out + 3 * plane * b + p;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) o[ch * plane] = v[ch];
}

}  // namespace

// buf: the batch's upload on the card (kernels/canvas.py::_pack): B
// descriptors of 9 int64, then each frame's x and y tap tables (int32) and
// its pixels (uint8 [h, w, 3], BGR or RGB), at the offsets the descriptors
// give;
// out [B, 3, Hc, Wc] f32. Requires 1 <= B <= 65535 and Hc Wc < 2^31.
extern "C" int tpuseg_canvas_f32(const void* buf, int b, int hc, int wc,
                                 float m0, float m1, float m2, float s0,
                                 float s1, float s2, int rgb, void* out,
                                 void* stream) {
  const Norm norm = {{m0, m1, m2}, {s0, s1, s2}, rgb};
  const long long plane = (long long)hc * wc;
  const dim3 grid((unsigned)((plane + kThreads - 1) / kThreads), b);
  canvas_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, hc, wc, norm, (float*)out);
  return (int)cudaGetLastError();
}
