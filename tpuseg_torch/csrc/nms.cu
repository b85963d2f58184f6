// Exact greedy NMS keep mask, batched over images.
//
// Replaces: tpuseg/ops/pallas/nms_pl.py::nms_mask_pallas_batched (the Pallas
// kernel _make_kernel, IoU _iou_cols). The caller (tpuseg_torch/ops/nms.py)
// sorts by score, builds the validity mask and scatters the keep mask back
// to the original order in plain torch, as the JAX wrapper does around the
// pallas_call; this file only sees score-sorted boxes.
//
// What bounds it on this card: not FLOPs or bytes (N <= 2048 boxes, a few
// MB of IoU work) but latency. Greedy NMS is a sequential recursion: box i
// survives iff no earlier survivor overlaps it. The TPU kernel walks tiles
// in grid order and iterates a whole-tile fixed point; on Hopper blocks run
// in parallel and in no order, so nothing can carry over between them.
//
// Design: split the work into the parallel part and the sequential part.
//  * Kernel A (nms_mask_kernel) computes all pairwise suppressions at once:
//    one block of 64 threads per (64 rows x 64 columns) tile of one image,
//    the column boxes in shared memory, one 64-bit word per row. Bit k of
//    word [b, i, j] is set when column c = 64*j + k comes after row i, both
//    are valid, and IoU(i, c) > thr. Tiles below the diagonal hold no such
//    column and write 0.
//  * Kernel B (nms_reduce_kernel) runs one block per image and walks the
//    rows in score order over a "removed" bitmask in shared memory. Per
//    64-row block, one thread resolves the chain inside the block with
//    register bit operations on the block's diagonal words; then all
//    threads OR the survivors' rows into the later words in parallel.
// The keep set must equal the plain torch version bit for bit, so the IoU
// is written with round-to-nearest intrinsics (no FMA contraction of
// area_a + area_b - inter) and a true division, in the same operation order
// as tpuseg_torch/core/boxes.py::iou_matrix.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;  // boxes per mask word
typedef unsigned long long u64;

__device__ __forceinline__ float extent(float lo, float hi, float to_remove) {
  return fmaxf(__fadd_rn(__fsub_rn(hi, lo), to_remove), 0.0f);
}

__device__ __forceinline__ float box_iou(const float4 a, const float4 b,
                                         float to_remove) {
  const float iw = extent(fmaxf(a.x, b.x), fminf(a.z, b.z), to_remove);
  const float ih = extent(fmaxf(a.y, b.y), fminf(a.w, b.w), to_remove);
  const float inter = __fmul_rn(iw, ih);
  const float area_a =
      __fmul_rn(extent(a.x, a.z, to_remove), extent(a.y, a.w, to_remove));
  const float area_b =
      __fmul_rn(extent(b.x, b.z, to_remove), extent(b.y, b.w, to_remove));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

// grid (col_blocks, col_blocks, B), block kBlock
__global__ void nms_mask_kernel(const float4* __restrict__ boxes,
                                const uint8_t* __restrict__ valid, int n,
                                int col_blocks, float thr, float to_remove,
                                u64* __restrict__ mask) {
  const int b = blockIdx.z;
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  const int row = row_block * kBlock + threadIdx.x;
  const size_t base = (size_t)b * n;
  if (row_block > col_block) {  // every column precedes every row
    if (row < n) mask[(base + row) * col_blocks + col_block] = 0ULL;
    return;
  }
  __shared__ float4 cbox[kBlock];
  __shared__ uint8_t cvalid[kBlock];
  const int col0 = col_block * kBlock;
  const int ncols = min(kBlock, n - col0);
  if (threadIdx.x < ncols) {
    cbox[threadIdx.x] = boxes[base + col0 + threadIdx.x];
    cvalid[threadIdx.x] = valid[base + col0 + threadIdx.x];
  }
  __syncthreads();
  if (row >= n) return;
  u64 bits = 0ULL;
  if (valid[base + row]) {
    const float4 r = boxes[base + row];
    const int start = (row_block == col_block) ? threadIdx.x + 1 : 0;
    for (int k = start; k < ncols; ++k) {
      if (cvalid[k] && box_iou(r, cbox[k], to_remove) > thr) bits |= 1ULL << k;
    }
  }
  mask[(base + row) * col_blocks + col_block] = bits;
}

// grid (B), block kBlock, dynamic shared col_blocks words
__global__ void nms_reduce_kernel(const u64* __restrict__ mask,
                                  const uint8_t* __restrict__ valid, int n,
                                  int col_blocks, uint8_t* __restrict__ keep) {
  extern __shared__ u64 removed[];
  __shared__ u64 diag[kBlock];
  __shared__ uint8_t vrow[kBlock];
  __shared__ u64 kept_block;
  const size_t base = (size_t)blockIdx.x * n;
  const u64* m = mask + base * col_blocks;
  for (int j = threadIdx.x; j < col_blocks; j += blockDim.x) removed[j] = 0ULL;
  __syncthreads();
  for (int r = 0; r < col_blocks; ++r) {
    const int row0 = r * kBlock;
    const int nrows = min(kBlock, n - row0);
    if (threadIdx.x < kBlock) {
      const int i = threadIdx.x;
      const uint8_t v = (i < nrows) ? valid[base + row0 + i] : 0;
      vrow[i] = v;
      diag[i] = v ? m[(size_t)(row0 + i) * col_blocks + r] : 0ULL;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      u64 rem = removed[r];
      u64 kept = 0ULL;
      for (int i = 0; i < nrows; ++i) {
        if (vrow[i] && !((rem >> i) & 1ULL)) {
          kept |= 1ULL << i;
          rem |= diag[i];
        }
      }
      removed[r] = rem;
      kept_block = kept;
    }
    __syncthreads();
    const u64 kept = kept_block;
    for (int j = r + 1 + threadIdx.x; j < col_blocks; j += blockDim.x) {
      u64 acc = removed[j];
      for (int i = 0; i < nrows; ++i) {
        if ((kept >> i) & 1ULL) acc |= m[(size_t)(row0 + i) * col_blocks + j];
      }
      removed[j] = acc;
    }
    if (threadIdx.x < nrows) {
      keep[base + row0 + threadIdx.x] = (uint8_t)((kept >> threadIdx.x) & 1ULL);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* tpuseg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// boxes [B, N, 4] f32 (score-sorted), valid [B, N] u8, mask scratch
// [B, N, ceil(N/64)] u64, keep [B, N] u8 out. Requires B >= 1, N >= 1.
extern "C" int tpuseg_nms_mask(const void* boxes, const void* valid,
                               void* mask, void* keep, int batch, int n,
                               float thr, float to_remove, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int col_blocks = (n + kBlock - 1) / kBlock;
  dim3 grid_a(col_blocks, col_blocks, batch);
  nms_mask_kernel<<<grid_a, kBlock, 0, s>>>(
      (const float4*)boxes, (const uint8_t*)valid, n, col_blocks, thr,
      to_remove, (u64*)mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_reduce_kernel<<<batch, kBlock, col_blocks * sizeof(u64), s>>>(
      (const u64*)mask, (const uint8_t*)valid, n, col_blocks, (uint8_t*)keep);
  return (int)cudaGetLastError();
}
