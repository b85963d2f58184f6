// YOLACT's mask paste: the kept detections' prototype-resolution masks
// upsampled to the image and binarised, in one kernel, as uint8.
//
// Replaces no TPU kernel. The JAX engine pastes on the host
// (tpuseg/engine/yolact_engine.py::YolactPredictor.postprocess_image,
// cv2.resize(INTER_LINEAR) and a threshold). The port adds this kernel
// because that host paste was 62 % of a streamed request: 100 masks of
// 138 x 138 f32 downloaded, upsampled to 480 x 640 in 123 MB of f32 and
// thresholded on the CPU. Here the masks stay on the card and only the
// finished uint8 masks cross to the host.
//
// Arithmetic: that of the CPU's upsample_bilinear2d (PyTorch's generic
// kernel, as built for x86-64 with FMA) with align_corners=False and an
// explicit output size. Per axis
//   scale = (float)S / H, src = max(fma(scale, dst + 0.5, -0.5), 0),
//   i0 = (int)src, i1 = i0 + (i0 < S - 1), l1 = src - i0, l0 = 1 - l1;
// a row's sample t = fma(m[x0], l0x, m[x1] l1x) and the value
// fma(t(y0), l0y, t(y1) l1y), in f32. A pixel is 1 where value > 0.5.
// Written out in numpy, this equals F.interpolate on such a host for every
// pixel; where the host rounds otherwise (no FMA, or the CUDA plain path),
// a rounding of the source coordinate moves a value by less than 1e-5 at
// S = 138, so only pixels within that of 0.5 can flip.
//
// What bounds it on this card: bytes, and the write dominates. At n = 100
// masks of 480 x 640, S = 138: n H W = 30.72 MB written and n S S 4 =
// 7.62 MB read, 11.4 us at 3.35 TB/s. The detector's masks are a [K, S, S]
// view of an [S, S, K] array, so each source value lies in a 32-byte
// sector of its own: a warp whose lanes sample neighbouring pixels of one
// mask from device memory touches up to 32 sectors per load.
//
// Design: one block per strip of `rows` output rows (about 8 KB) of one
// kept mask, in four steps with shared memory between them.
//  0. The strip's source rows (about scale (rows - 1) + 2 of them) are
//     read once, detection k's mask being masks[index[k]] through its
//     strides: the valid selection and the layout cost no copy of the
//     masks, and each source value is read once a strip.
//  1. Each source row is sampled at every output column (t above), one
//     column a thread, so a row's samples are computed once a strip.
//  2. Each output pixel weighs its two rows' samples and is binarised into
//     a byte buffer, one pixel a thread with neighbouring threads on
//     neighbouring pixels (no bank conflicts).
//  3. The strip's bytes are contiguous in the output; they are stored as
//     aligned 16-byte vectors, the buffer being offset by the strip's
//     misalignment, and byte by byte only in the two partial vectors at
//     its ends (which a neighbouring strip shares).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStripBytes = 8192;  // output bytes a block aims at
constexpr int kMaxRows = 256;      // a strip's rows, for very narrow images

// One output coordinate's two source indices and their weights.
struct Tap {
  int i0, i1;
  float l0, l1;
};

// f32 arithmetic rounded as written, on the card and on the host alike
// (the host sizes shared memory from the kernel's own taps)
__host__ __device__ __forceinline__ float fma_rn(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return fmaf(a, b, c);
#endif
}

__host__ __device__ __forceinline__ float add_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

__host__ __device__ __forceinline__ Tap tap(int dst, float scale, int size) {
  const float src = fmaxf(fma_rn(scale, add_rn((float)dst, 0.5f), -0.5f),
                          0.0f);
  Tap t;
  t.i0 = (int)src;
  t.i1 = t.i0 + (t.i0 < size - 1 ? 1 : 0);
  t.l1 = add_rn(src, -(float)t.i0);
  t.l0 = add_rn(1.0f, -t.l1);
  return t;
}

// The most source rows a strip of `rows` output rows reads: the kernel's
// own count, strip by strip, so shared memory is never one row short.
int strip_src_rows(int rows, int h, float scale, int s) {
  int most = 1;
  for (int r0 = 0; r0 < h; r0 += rows) {
    const int last = (r0 + rows < h ? r0 + rows : h) - 1;
    const int ns = tap(last, scale, s).i1 - tap(r0, scale, s).i0 + 1;
    most = ns > most ? ns : most;
  }
  return most;
}

// Bytes of step 0's and 1's f32 rows, aligned to 16.
__host__ __device__ __forceinline__ size_t rows_bytes(int src_rows, int s,
                                                       int w) {
  return ((size_t)src_rows * (s + w) * sizeof(float) + 15) / 16 * 16;
}

size_t smem_bytes(int rows, int h, int s, int w, float scale) {
  return rows_bytes(strip_src_rows(rows, h, scale, s), s, w) +
         (size_t)rows * w + 16;
}

__global__ void __launch_bounds__(kThreads)
    mask_paste_kernel(const float* __restrict__ masks, long long sk,
                      long long sy, long long sx,
                      const long long* __restrict__ index, int s, int h,
                      int w, int rows, float scale_y, float scale_x,
                      uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, h - r0);
  const int ya = tap(r0, scale_y, s).i0;
  const int ns = tap(r0 + nr - 1, scale_y, s).i1 - ya + 1;
  float* src = (float*)smem;   // [ns][s]
  float* hrow = src + ns * s;  // [ns][w]
  const long long start = ((long long)k * h + r0) * w;
  const int mis = (int)(start & 15);
  unsigned char* buf = smem + rows_bytes(ns, s, w);  // [mis + nr w]

  // 0. the source rows
  const float* m = masks + __ldg(index + k) * sk;
  for (int i = threadIdx.x; i < ns * s; i += kThreads) {
    const int r = i / s;
    src[i] = __ldg(m + (ya + r) * sy + (i - r * s) * sx);
  }
  __syncthreads();
  // 1. each source row sampled at every output column
  for (int x = threadIdx.x; x < w; x += kThreads) {
    const Tap tx = tap(x, scale_x, s);
    for (int r = 0; r < ns; ++r) {
      const float* row = src + r * s;
      hrow[r * w + x] =
          __fmaf_rn(row[tx.i0], tx.l0, __fmul_rn(row[tx.i1], tx.l1));
    }
  }
  __syncthreads();
  // 2. the pixels, binarised
  const int len = nr * w;
  int yy = threadIdx.x / w, x = threadIdx.x - yy * w, cur = -1;
  const float *h0 = hrow, *h1 = hrow;
  float l0 = 0.0f, l1 = 0.0f;
  for (int o = threadIdx.x; o < len; o += kThreads) {
    if (yy != cur) {
      cur = yy;
      const Tap ty = tap(r0 + yy, scale_y, s);
      h0 = hrow + (ty.i0 - ya) * w;
      h1 = hrow + (ty.i1 - ya) * w;
      l0 = ty.l0;
      l1 = ty.l1;
    }
    buf[mis + o] = __fmaf_rn(h0[x], l0, __fmul_rn(h1[x], l1)) > 0.5f;
    for (x += kThreads; x >= w; x -= w) ++yy;
  }
  __syncthreads();
  // 3. the strip, in aligned 16-byte vectors
  uint8_t* dst = out + (start - mis);
  const int end = mis + len;
  for (int b = 16 * threadIdx.x; b < end; b += 16 * kThreads) {
    if (b >= mis && b + 16 <= end) {
      *(uint4*)(dst + b) = *(const uint4*)(buf + b);
    } else {
      for (int e = max(b, mis); e < min(b + 16, end); ++e) dst[e] = buf[e];
    }
  }
}

}  // namespace

// masks: element (j, i, c) of the [M, S, S] f32 masks at masks + j sk + i
// sy + c sx; index [n] int64 of slots in [0, M); out [n, H, W] u8, 16-byte
// aligned. Requires 1 <= n <= 65535, H, W >= 1 and a strip of one row
// within the card's shared memory (W <= 16384 at S <= 1024).
extern "C" int tpuseg_mask_paste_f32(const void* masks, long long sk,
                                     long long sy, long long sx,
                                     const void* index, int n, int s, int h,
                                     int w, void* out, void* stream) {
  const float scale_y = (float)s / (float)h, scale_x = (float)s / (float)w;
  int rows = kStripBytes / w;
  rows = rows < 1 ? 1 : rows > kMaxRows ? kMaxRows : rows;
  rows = rows > h ? h : rows;
  while (rows > 1 && smem_bytes(rows, h, s, w, scale_y) > 48 * 1024) --rows;
  const size_t smem = smem_bytes(rows, h, s, w, scale_y);
  if (smem > 48 * 1024) {  // above the default limit
    const cudaError_t err = cudaFuncSetAttribute(
        mask_paste_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((h + rows - 1) / rows, n);
  mask_paste_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)masks, sk, sy, sx, (const long long*)index, s, h, w, rows,
      scale_y, scale_x, (uint8_t*)out);
  return (int)cudaGetLastError();
}
