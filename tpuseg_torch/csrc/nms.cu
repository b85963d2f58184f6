// Exact greedy NMS keep mask, batched over images.
//
// Replaces: tpuseg/ops/pallas/nms_pl.py::nms_mask_pallas_batched (the Pallas
// kernel _make_kernel, IoU _iou_cols). The caller (tpuseg_torch/ops/nms.py)
// sorts the scores in plain torch, as the JAX wrapper keeps _sort_desc
// outside its pallas_call; this file reads the boxes through that order and
// writes the keep mask back in the boxes' own order.
//
// What bounds it on this card: not FLOPs or bytes (a few MB of IoU work at
// the main paths' N <= 2048) but latency. Greedy NMS is a sequential
// recursion: box i survives iff no earlier survivor overlaps it. The TPU
// kernel walks tiles in grid order and iterates a whole-tile fixed point; on
// Hopper blocks run in parallel and in no order, so nothing can carry over
// between them.
//
// Design: the parallel part and the sequential part apart.
//  * Kernel A (nms_mask_kernel) computes all pairwise suppressions at once:
//    one block of 64 threads per (64 rows x 64 columns) tile on or above the
//    diagonal, one image per grid z. It reads boxes[order[i]] and the
//    sorted validity itself (no gathered copy). Off the diagonal, word
//    (r, j, i) has bit k set when row 64r+i and column 64j+k are both valid
//    and IoU > thr. A diagonal tile is written by column: word (r, r, k) has
//    bit i < k set when row i suppresses column k, and bit k set when box k
//    is valid. Each row block's words are contiguous and cut into pieces of
//    at most kPiece column blocks, each row-major ([row][column block]).
//  * Kernel B (nms_reduce_kernel) runs one 256-thread block per image and
//    walks the pieces in order over a `removed` bitmask in shared memory.
//    One thread keeps kStages - 1 pieces in flight ahead of the block with
//    bulk asynchronous copies (cp.async.bulk) completing on mbarriers, so a
//    piece is in shared memory when its turn comes. On a row block's first
//    piece every warp resolves the 64-row chain in registers from the
//    staged diagonal words: kept = candidates, then kept(k) = candidate(k)
//    and no kept i < k suppresses k, by ballots, until nothing changes (the
//    unique fixed point, which greedy NMS is; as many rounds as the longest
//    chain of suppressions, not one round per row). Then the block ORs the
//    survivors' rows into `removed` in parallel: a few threads per column
//    word, each over a range of rows, one shared atomicOr per non-zero
//    result. At the end the block writes keep[order[i]] for every i: the
//    scatter back to the original order.
//  A chain resolved by one thread, row after row, with the ORs as serial
//  global loads costs ~11 us per row block; this costs ~1.4 us.
// The keep set must equal the plain torch version bit for bit, so the IoU
// is written with round-to-nearest intrinsics (no FMA contraction of
// area_a + area_b - inter) and a true division, in the same operation order
// as tpuseg_torch/core/boxes.py::iou_matrix (symmetric in its two boxes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;    // boxes per mask word
constexpr int kPiece = 64;    // most column blocks in one staged piece
constexpr int kStages = 4;    // staged pieces in kernel B's ring
constexpr int kThreadsB = 256;
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

// Tiles (r, j >= r) of the row blocks before r; tiles_before(nb, nb) is
// the image's count.
__host__ __device__ __forceinline__ long long tiles_before(int r, int nb) {
  return (long long)r * nb - (long long)r * (r - 1) / 2;
}

// column blocks in piece p of row block r
__device__ __forceinline__ int piece_width(int r, int p, int nb) {
  return min(kPiece, nb - r - p * kPiece);
}

// first word of piece p of row block r in one image's mask
__device__ __forceinline__ long long piece_start(int r, int p, int nb) {
  return (tiles_before(r, nb) + (long long)p * kPiece) * kBlock;
}

// grid (nb, nb, B), block kBlock
__global__ void nms_mask_kernel(const float4* __restrict__ boxes,
                                const long long* __restrict__ order,
                                const uint8_t* __restrict__ svalid, int n,
                                int nb, float thr, float to_remove,
                                u64* __restrict__ mask) {
  const int j = blockIdx.x;
  const int r = blockIdx.y;
  if (r > j) return;  // every column precedes every row: nothing stored
  const size_t base = (size_t)blockIdx.z * n;
  const int t = threadIdx.x;
  __shared__ float4 cbox[kBlock];
  __shared__ uint8_t cvalid[kBlock];
  const int col0 = j * kBlock;
  const int ncols = min(kBlock, n - col0);
  cvalid[t] = 0;
  if (t < ncols) {
    cbox[t] = boxes[base + order[base + col0 + t]];
    cvalid[t] = svalid[base + col0 + t];
  }
  __syncthreads();
  u64 bits = 0ULL;
  if (r == j) {  // by column: t is the column, its rows are i < t
    if (cvalid[t]) {
      bits = 1ULL << t;
      for (int i = 0; i < t; ++i) {
        if (cvalid[i] && box_iou(cbox[i], cbox[t], to_remove) > thr) {
          bits |= 1ULL << i;
        }
      }
    }
  } else {  // by row: t is the row
    const int row = r * kBlock + t;
    if (row < n && svalid[base + row]) {
      const float4 rb = boxes[base + order[base + row]];
      for (int k = 0; k < ncols; ++k) {
        if (cvalid[k] && box_iou(rb, cbox[k], to_remove) > thr) {
          bits |= 1ULL << k;
        }
      }
    }
  }
  const int p = (j - r) / kPiece;
  const int jj = j - r - p * kPiece;
  mask[(size_t)blockIdx.z * tiles_before(nb, nb) * kBlock +
       piece_start(r, p, nb) + (long long)t * piece_width(r, p, nb) + jj] =
      bits;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy piece p of row block r into `dst`; its bytes complete `bar`.
__device__ __forceinline__ void issue_piece(const u64* m, int r, int p,
                                            int nb, u64* dst, u64* bar) {
  const uint32_t bytes = kBlock * piece_width(r, p, nb) * sizeof(u64);
  const u64* src = m + piece_start(r, p, nb);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wait_phase(u64* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// grid (B), block kThreadsB; dynamic shared memory: kStages slots of
// kBlock * min(kPiece, nb) words, then `removed` and `kept` (nb words each)
__global__ void __launch_bounds__(kThreadsB)
    nms_reduce_kernel(const u64* __restrict__ mask,
                      const long long* __restrict__ order, int n, int nb,
                      uint8_t* __restrict__ keep) {
  extern __shared__ __align__(128) u64 smem[];
  __shared__ __align__(8) u64 full[kStages];
  const int slot_words = kBlock * min(kPiece, nb);
  u64* removed = smem + kStages * slot_words;
  u64* kept_words = removed + nb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t base = (size_t)blockIdx.x * n;
  const u64* m = mask + (size_t)blockIdx.x * tiles_before(nb, nb) * kBlock;
  for (int i = tid; i < nb; i += kThreadsB) removed[i] = 0ULL;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(&full[s])),
                   "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the producer (thread 0): the next piece to copy and how many it copied
  int pr = 0, pp = 0, issued = 0;
  auto produce = [&]() {
    issue_piece(m, pr, pp, nb, smem + (issued % kStages) * slot_words,
                &full[issued % kStages]);
    ++issued;
    if (++pp * kPiece >= nb - pr) ++pr, pp = 0;
  };
  if (tid == 0) {
    while (issued < kStages - 1 && pr < nb) produce();
  }
  u64 kept = 0ULL;  // survivors of the current row block
  int r = 0, p = 0;
  for (int step = 0; r < nb; ++step) {
    // the slot of piece step + kStages - 1 was read in the last step
    if (tid == 0 && pr < nb) produce();
    const int slot = step % kStages;
    wait_phase(&full[slot], (step / kStages) & 1);
    const u64* buf = smem + slot * slot_words;
    const int width = piece_width(r, p, nb);
    if (p == 0) {
      // every warp resolves the chain (no barrier before the OR step);
      // lane holds columns lane and lane + 32 of the diagonal tile
      const u64 wa = buf[lane * width];
      const u64 wb = buf[(lane + 32) * width];
      const u64 va = __ballot_sync(0xffffffffu, (wa >> lane) & 1ULL);
      const u64 vb = __ballot_sync(0xffffffffu, (wb >> (lane + 32)) & 1ULL);
      const u64 cand = (va | vb << 32) & ~removed[r];
      const u64 sa = wa & ~(1ULL << lane);
      const u64 sb = wb & ~(1ULL << (lane + 32));
      const bool ca = (cand >> lane) & 1ULL;
      const bool cb = (cand >> (lane + 32)) & 1ULL;
      kept = cand;
      for (;;) {
        const u64 ka = __ballot_sync(0xffffffffu, ca && !(sa & kept));
        const u64 kb = __ballot_sync(0xffffffffu, cb && !(sb & kept));
        const u64 next = ka | kb << 32;
        if (next == kept) break;
        kept = next;
      }
      if (tid == 0) kept_words[r] = kept;
    }
    // OR the survivors' rows into the later column blocks of this piece:
    // `groups` threads per column, each over a range of `span` rows
    const int first = p == 0 ? 1 : 0;  // the diagonal is done
    const int cols = width - first;
    if (cols > 0 && kept != 0ULL) {
      const int groups = kThreadsB / cols;
      const int span = (kBlock + groups - 1) / groups;
      const int q = tid / cols;
      const int lo = q * span;
      if (q < groups && lo < kBlock) {
        const int jj = first + tid - q * cols;
        const int hi = min(kBlock, lo + span);
        const u64 below_hi = hi == kBlock ? ~0ULL : (1ULL << hi) - 1ULL;
        u64 rows = kept & below_hi & ~((1ULL << lo) - 1ULL);
        u64 acc = 0ULL;
        while (rows) {
          const int i = __ffsll((long long)rows) - 1;
          rows &= rows - 1ULL;
          acc |= buf[i * width + jj];
        }
        if (acc) atomicOr(&removed[r + p * kPiece + jj], acc);
      }
    }
    __syncthreads();
    if (++p * kPiece >= nb - r) ++r, p = 0;
  }
  // the keep mask in the boxes' own order
  for (int i = tid; i < n; i += kThreadsB) {
    keep[base + order[base + i]] =
        (uint8_t)((kept_words[i >> 6] >> (i & 63)) & 1ULL);
  }
}

}  // namespace

extern "C" const char* tpuseg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// boxes [B, N, 4] f32 in their own order, order [B, N] int64 (the indices
// of the score-descending sort), svalid [B, N] u8 in sorted order, mask
// scratch of B * T * 64 u64 words with T = nb (nb + 1) / 2, nb = ceil(N /
// 64), keep [B, N] u8 out in the boxes' own order. Requires 1 <= B <= 65535
// and 1 <= N.
extern "C" int tpuseg_nms_mask(const void* boxes, const void* order,
                               const void* svalid, void* mask, void* keep,
                               int batch, int n, float thr, float to_remove,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (n + kBlock - 1) / kBlock;
  dim3 grid_a(nb, nb, batch);
  nms_mask_kernel<<<grid_a, kBlock, 0, s>>>(
      (const float4*)boxes, (const long long*)order, (const uint8_t*)svalid, n,
      nb, thr, to_remove, (u64*)mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      ((size_t)kStages * kBlock * (nb < kPiece ? nb : kPiece) + 2 * (size_t)nb) *
      sizeof(u64);
  if (smem > 48 * 1024) {  // above the default limit
    err = cudaFuncSetAttribute(nms_reduce_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_reduce_kernel<<<batch, kThreadsB, smem, s>>>(
      (const u64*)mask, (const long long*)order, n, nb, (uint8_t*)keep);
  return (int)cudaGetLastError();
}
