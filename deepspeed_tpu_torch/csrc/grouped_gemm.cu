// Grouped GEMMs over expert-sorted rows (the MoE expert FFN's three products
// and their backward) for Hopper (sm_90a). Built by
// deepspeed_tpu_torch/ops/cuda_build.py with nvcc into a shared library with
// a plain C interface, called through ctypes by
// deepspeed_tpu_torch/ops/grouped_gemm.py (grouped_matmul and its autograd
// backward, grouped_matmul_dx and grouped_matmul_dw).
//
// Replaces the TPU kernels reached from deepspeed_tpu/ops/pallas/grouped_gemm.py
// (`_moe_ffn_gmm_local`, whose three megablox `gmm` calls reach
// pl.pallas_call; public entry `moe_ffn_gmm`) and, under jax.grad, megablox's
// custom-VJP backward of each of those calls (megablox/ops.py `_gmm_bwd`):
//   forward  out[r, :] = xs[r, :] @ w[e(r)]          megablox gmm
//   dx       dx[r, :]  = dy[r, :] @ w[e(r)]^T        gmm(transpose_rhs=True)
//   dW       dW[e]     = xs[rows_e]^T @ dy[rows_e]   tgmm (visit_empty_groups)
// with xs [R, K], w [E, K, N], dy [R, N], rows already sorted by expert and
// e(r) the expert whose range group_offsets[e] <= r < group_offsets[e + 1]
// holds r (group_offsets [E + 1] int32 on the device); fp32 accumulation,
// rounded once to the dtype (preferred_element_type=float32, then the cast).
// dW of an expert with no rows is zero.
//
// What bounds it on the H100. A decode round has few rows per expert
// (R = 2 x tokens spread over 8 experts): every touched expert's [K, N]
// weights are read once for a handful of rows, so it is bound by HBM bytes
// (Mixtral-8x7B: up to 8 x 4096 x 14336 x 2 B = 0.94 GB per product, 0.28 ms
// at 3.35 TB/s). A SplitFuse round or a training micro-batch with thousands
// of rows per expert does 2 R K N operations on the same bytes and is bound
// by the tensor cores (forward 2 x 8192 x 4096 x 14336 = 0.96 TFLOP, 0.97 ms
// at 989 TFLOP/s; a training micro-batch of 16384 rows twice that, for each
// of forward, dx and dW).
//
// What the design does about it. The TPU kernel walks a sequential grid
// whose group metadata (which tile belongs to which expert) megablox
// computes on the host side of the trace, and pads the rows to its 128-row
// tile. Here blocks run in no order, and nothing reads the group sizes on
// the host, so no product costs a host sync. The kernels, chosen in the
// source by product and dtype (grouped_route, exported as ds_grouped_route;
// ds_grouped_kernel_launches counts what each call launched):
//   - bf16 / fp16 forward and dx, at every row count: grouped_gemm_wgmma,
//     warp-specialised and persistent. One block per SM walks the tiles
//     i, i + grid, ... of all experts (128 rows x 256 columns each, expert
//     by expert, in groups of 8 row tiles so that the tiles in flight share
//     rows and weight columns in L2), finding each tile's expert from
//     group_offsets on the device. A producer warp keeps a 4-stage ring of
//     TMA loads in flight (A: 128 rows x 64 of the contraction, 2-D tensor
//     map; B: w[e] through a 3-D tensor map); two consumer warpgroups run
//     wgmma m64n128k16 (64 rows x 256 columns each, fp32 accumulators),
//     releasing each stage once its products are done. The forward reads
//     w[e] [K, N] as an MN-major B through the transpose bit, dx (which
//     contracts w's contiguous axis) as a K-major B, so one template serves
//     both. A's rows past the group's end are loaded (the next expert's
//     rows, or zeros past R) and never stored; nothing is padded. Bound by
//     operations at training and prefill shapes (2 R K N on the tensor
//     cores); bound by the weights' bytes at a decode round (16-128 rows
//     over 8 experts), where a tile computes mostly rows it never stores but
//     the 4-stage ring keeps every SM streaming its weight columns; its
//     epilogue stores from registers;
//   - bf16 dW: grouped_tgmm_wgmma, the same persistent, warp-specialised
//     shape over output tiles (expert, 128 rows of K, 256 columns of N),
//     the experts with the most rows first (each block sorts them from
//     group_offsets), contracting the expert's rows 64 a stage. The rows are
//     the contraction, so both operands are MN-major: xs through wgmma's
//     A-transpose bit, dy as the forward's B. A stage that runs past the
//     expert's last row holds the next expert's rows, which would add into
//     this expert's sum: the consumers zero those rows of both operands
//     before their products read them. An expert with no rows stores
//     zeros;
//   - fp32: SIMT kernels (64 x 64 tiles, FMAs on CUDA cores): TF32 tensor
//     cores would round the inputs. The backward takes bf16 and fp32,
//     megablox's dtypes.
// Products of two bf16/fp16 values are exact in fp32, so every kernel and
// its plain version differ only in summation order before the one
// rounding. Ragged K and N edges read zeros (TMA's fill) and are never
// stored; K and N must be multiples of 8 (16-byte rows). Later work: a TMA
// store epilogue, and dW's rows split over blocks where one expert's tiles
// are fewer than the SMs.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;       // the SIMT kernels' blocks

// Row tiles are numbered expert by expert: expert e owns ceil(size_e / BM)
// of them. Finds tile t's expert and row range [row0, row1).
template <int BM>
__device__ __forceinline__ bool find_tile(const int* __restrict__ offsets, int E, int t,
                                          int& expert, int& row0, int& row1) {
  for (int e = 0; e < E; ++e) {
    const int lo = offsets[e];
    const int hi = offsets[e + 1];
    const int tiles = (max(hi - lo, 0) + BM - 1) / BM;
    if (t < tiles) {
      expert = e;
      row0 = lo + t * BM;
      row1 = min(row0 + BM, hi);
      return true;
    }
    t -= tiles;
  }
  return false;
}

template <typename T>
struct Tc;

template <>
struct Tc<__nv_bfloat16> {
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
};

template <>
struct Tc<__half> {
  static __device__ __forceinline__ void store2(__half* p, float x, float y) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  }
};

// ---------------------------------------------------------------------------
// bf16 / fp16 forward and dx on wgmma, fed by TMA (warp-specialised,
// persistent)
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;          // rows per output tile: two consumer warpgroups of 64
constexpr int kWgBN = 256;          // columns per output tile: two m64n128 products each
constexpr int kWgBK = 64;           // contraction per stage: one 128-byte swizzled block
constexpr int kWgStages = 4;
constexpr int kWgThreads = 3 * 128; // two consumer warpgroups, then the producer's
constexpr int kWgGroupRows = 8;     // row tiles per rasterisation group
constexpr uint32_t kWgABytes = kWgBM * kWgBK * 2;            // A [128 rows][64]
constexpr uint32_t kWgBBytes = kWgBN * kWgBK * 2;            // B, 256 columns by 64
constexpr uint32_t kWgStageBytes = kWgABytes + kWgBBytes;    // 48 KB
constexpr uint32_t kWgMnBlock = kWgBK * 128;                 // MN-major B: [64 k][64 n]
constexpr int kWgSmemBytes = 1024 + kWgStages * kWgStageBytes + 8 * 2 * kWgStages;
constexpr int kWgProducerRegs = 40, kWgConsumerRegs = 232;

struct WgTile {
  int expert, row0, row1, n0;
};

// Tile t of the launch's tiles, numbered expert by expert: expert e has
// ceil(size_e / 128) row tiles times n_ct column tiles, taken in groups of
// kWgGroupRows row tiles and, within a group, column tile by column tile, so
// that the tiles in flight at once share a few experts' rows and weight
// columns in L2. False past the last tile.
__device__ __forceinline__ bool wg_tile(const int* __restrict__ offsets, int E, int n_ct, int t,
                                        WgTile& tile) {
  for (int e = 0; e < E; ++e) {
    const int lo = __ldg(offsets + e), hi = __ldg(offsets + e + 1);
    const int rt = (max(hi - lo, 0) + kWgBM - 1) / kWgBM;
    if (t < rt * n_ct) {
      const int group = t / (kWgGroupRows * n_ct);
      const int first = group * kWgGroupRows;
      const int rows = min(kWgGroupRows, rt - first);
      const int u = t - group * kWgGroupRows * n_ct;
      tile.expert = e;
      tile.row0 = lo + (first + u % rows) * kWgBM;
      tile.row1 = min(tile.row0 + kWgBM, hi);
      tile.n0 = (u / rows) * kWgBN;
      return true;
    }
    t -= rt * n_ct;
  }
  return false;
}

// Stores a consumer warpgroup's 64 x 256 fp32 accumulators, rounded once,
// into a row-major matrix of ld columns: acc[h][4 j + e] is row r_first +
// 16 (warp % 4) + lane / 4 + 8 (e / 2), column n0 + 128 h + 8 j + 2 (lane %
// 4) + e % 2; rows at or past row_end and columns at or past ld are not
// stored (ld % 8 == 0 keeps each pair inside or outside together).
template <typename T>
__device__ __forceinline__ void store_acc(T* __restrict__ out, const float (&acc)[2][64],
                                          int r_first, int row_end, int n0, int ld, int warp,
                                          int lane) {
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = r_first + 16 * (warp % 4) + lane / 4 + 8 * e2;
    if (row >= row_end) continue;
    T* orow = out + static_cast<int64_t>(row) * ld;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 128 * h + 8 * j + 2 * (lane % 4);
        if (col < ld) Tc<T>::store2(orow + col, acc[h][4 * j + 2 * e2], acc[h][4 * j + 2 * e2 + 1]);
      }
  }
}

// out [R, Nout] = a [R, Kc] @ op(w[e(r)]) for the rows of every expert,
// w[e] stored [Kc, Nout] (forward: B read MN-major through the transpose
// bit) or [Nout, Kc] (dx: B K-major). A persistent grid: block i takes
// tiles i, i + gridDim.x, ... of wg_tile's order. The producer warp's lane 0
// streams A (rows row0 .. row0 + 127 of a, through tensor map ta: rows past
// the group's end are loaded, being the next expert's rows or zeros past R,
// and never stored) and B (tensor map tb over w [E, ., .]) through a ring of
// kWgStages stages; each consumer warpgroup issues wgmma on its 64 rows x
// 256 columns, fp32 accumulators in registers, releases each stage as soon
// as the products reading it are done, and stores its rows below row1 and
// columns below Nout, rounded once.
template <typename T, bool kTransB>
__global__ void __launch_bounds__(kWgThreads, 1)
    grouped_gemm_wgmma(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb, const int* __restrict__ offsets,
                       T* __restrict__ out, int Kc, int Nout, int E) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                               ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  const int n_ct = (Nout + kWgBN - 1) / kWgBN;
  const int k_iters = (Kc + kWgBK - 1) / kWgBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  WgTile tile;
  if (warp >= 8) {
    hopper::setmaxnreg_dec<kWgProducerRegs>();
    if (warp != 8 || lane != 0) return;
    int it = 0;
    for (int t = blockIdx.x; wg_tile(offsets, E, n_ct, t, tile); t += gridDim.x)
      for (int ks = 0; ks < k_iters; ++ks, ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) hopper::mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
        uint8_t* st = stages + s * kWgStageBytes;
        hopper::mbar_arrive_expect_tx(&full[s], kWgStageBytes);
        hopper::tma_load_2d(st, &ta, &full[s], ks * kWgBK, tile.row0);
        if constexpr (kTransB) {
          hopper::tma_load_3d(st + kWgABytes, &tb, &full[s], ks * kWgBK, tile.n0, tile.expert);
        } else {
#pragma unroll
          for (int c = 0; c < kWgBN / 64; ++c)
            hopper::tma_load_3d(st + kWgABytes + c * kWgMnBlock, &tb, &full[s], tile.n0 + 64 * c,
                                ks * kWgBK, tile.expert);
        }
      }
    return;
  }
  hopper::setmaxnreg_inc<kWgConsumerRegs>();

  const int wg = warp / 4;
  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  int it = 0;
  for (int t = blockIdx.x; wg_tile(offsets, E, n_ct, t, tile); t += gridDim.x) {
    for (int ks = 0; ks < k_iters; ++ks, ++it) {
      const int s = it % kWgStages;
      hopper::mbar_wait(&full[s], (it / kWgStages) & 1);
      const uint32_t a_rows = hopper::smem_u32(stages + s * kWgStageBytes) + 64 * wg * 128;
      const uint32_t b_tile = hopper::smem_u32(stages + s * kWgStageBytes + kWgABytes);
      hopper::fence_regs(acc[0]);
      hopper::fence_regs(acc[1]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(a_rows + kk * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // dx: rows 128 h .. of the K-major [256][64] block, 32 bytes a k-step;
          // forward: column blocks 2 h, 2 h + 1 of [64 k][64 n], 16 k rows a k-step
          const uint64_t db =
              kTransB ? hopper::desc_sw128(b_tile + h * 128 * 128 + kk * 32)
                      : hopper::desc_sw128(b_tile + 2 * h * kWgMnBlock + kk * 16 * 128, kWgMnBlock);
          hopper::wgmma_ss_n128<T, !kTransB>(acc[h], da, db, ks > 0 || kk > 0);
        }
      }
      hopper::wgmma_commit();
      if (ks > 0) {   // the previous stage's products are done: release it
        hopper::wgmma_wait<1>();
        hopper::mbar_arrive(&empty[(it - 1) % kWgStages]);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    if (k_iters > 0) hopper::mbar_arrive(&empty[(it - 1) % kWgStages]);

    store_acc(out, acc, tile.row0 + 64 * wg, tile.row1, tile.n0, Nout, warp, lane);
  }
}

// ---------------------------------------------------------------------------
// bf16 dW on wgmma, fed by TMA (the same persistent, warp-specialised shape)
// ---------------------------------------------------------------------------

struct DwTile {
  int expert, row0, row1, m0, n0;
};

// Tile t of the dW launch: every expert owns n_mt x n_nt output tiles of
// 128 rows (of K) x 256 columns (of N), whatever its row count; the experts
// are taken in `order` (most rows first), and an expert's tiles in groups of
// kWgGroupRows row tiles, column tile by column tile within a group, so that
// the tiles in flight share a few column blocks of xs and dy in L2. False
// past the last tile.
__device__ __forceinline__ bool dw_tile(const int* __restrict__ offsets,
                                        const int* __restrict__ order, int E, int n_mt, int n_nt,
                                        int t, DwTile& tile) {
  const int per_expert = n_mt * n_nt;
  const int pos = t / per_expert;
  if (pos >= E) return false;
  const int e = order[pos];
  const int u = t - pos * per_expert;
  const int group = u / (kWgGroupRows * n_nt);
  const int first = group * kWgGroupRows;
  const int rows = min(kWgGroupRows, n_mt - first);
  const int v = u - group * kWgGroupRows * n_nt;
  tile.expert = e;
  tile.row0 = __ldg(offsets + e);
  tile.row1 = max(__ldg(offsets + e + 1), tile.row0);
  tile.m0 = (first + v % rows) * kWgBM;
  tile.n0 = (v / rows) * kWgBN;
  return true;
}

// dW[e] [K, N] = xs[rows_e]^T @ dy[rows_e] for every expert, rows_e =
// [offsets[e], offsets[e + 1]), xs [R, K] and dy [R, N] read through tensor
// maps ta and tb in boxes of 64 rows x 64 columns. A persistent grid:
// block i takes tiles i, i + gridDim.x, ... of dw_tile's order, the experts
// sorted by row count, most first, at the start of the block (a skewed
// routing's large expert starts first and the small ones fill the tail).
// The rows are the contraction, so both operands are MN-major: each stage
// holds 64 rows of xs (two column blocks, the two consumer warpgroups' 64
// output rows each, read as an MN-major A through the transpose bit) and
// of dy (four column blocks, an MN-major B as in the forward). A stage
// starting at row0 + 64 i reads rows past row1 too: the next expert's rows
// (or TMA's zeros past R, or rows past group_offsets[E] that belong to no
// expert and may hold anything), which in dW would add into this expert's
// sum, so the consumer warpgroups write zeros over those rows of both
// operands (a zero A row alone would still turn an inf or NaN of dy into
// NaN) before their products read them. An expert with no rows runs no
// stage and stores zeros.
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    grouped_tgmm_wgmma(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb, const int* __restrict__ offsets,
                       T* __restrict__ out, int K, int N, int E) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                               ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  int* order = reinterpret_cast<int*>(empty + kWgStages);   // [E]: experts, most rows first
  const int n_mt = (K + kWgBM - 1) / kWgBM, n_nt = (N + kWgBN - 1) / kWgBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int size = max(__ldg(offsets + e + 1) - __ldg(offsets + e), 0);
    int rank = 0;
    for (int f = 0; f < E; ++f) {
      const int sf = max(__ldg(offsets + f + 1) - __ldg(offsets + f), 0);
      rank += sf > size || (sf == size && f < e);
    }
    order[rank] = e;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  DwTile tile;
  if (warp >= 8) {
    hopper::setmaxnreg_dec<kWgProducerRegs>();
    if (warp != 8 || lane != 0) return;
    int it = 0;
    for (int t = blockIdx.x; dw_tile(offsets, order, E, n_mt, n_nt, t, tile); t += gridDim.x) {
      const int k_iters = (tile.row1 - tile.row0 + kWgBK - 1) / kWgBK;
      for (int ks = 0; ks < k_iters; ++ks, ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) hopper::mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
        uint8_t* st = stages + s * kWgStageBytes;
        const int r = tile.row0 + ks * kWgBK;
        hopper::mbar_arrive_expect_tx(&full[s], kWgStageBytes);
#pragma unroll
        for (int c = 0; c < kWgBM / 64; ++c)
          hopper::tma_load_2d(st + c * kWgMnBlock, &ta, &full[s], tile.m0 + 64 * c, r);
#pragma unroll
        for (int c = 0; c < kWgBN / 64; ++c)
          hopper::tma_load_2d(st + kWgABytes + c * kWgMnBlock, &tb, &full[s], tile.n0 + 64 * c, r);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<kWgConsumerRegs>();

  const int wg = warp / 4;
  float acc[2][64];
  int it = 0;
  for (int t = blockIdx.x; dw_tile(offsets, order, E, n_mt, n_nt, t, tile); t += gridDim.x) {
    const int k_iters = (tile.row1 - tile.row0 + kWgBK - 1) / kWgBK;
    for (int ks = 0; ks < k_iters; ++ks, ++it) {
      const int s = it % kWgStages;
      hopper::mbar_wait(&full[s], (it / kWgStages) & 1);
      uint8_t* stage = stages + s * kWgStageBytes;
      uint8_t* a_block = stage + wg * kWgMnBlock;   // [64 rows][64 of K]
      const int live = tile.row1 - (tile.row0 + ks * kWgBK);
      if (live < kWgBK) {
        // the last stage: zero the rows of the next expert (or past R) in
        // both operands, this warpgroup's A block and two of the four B
        // blocks (0 x inf would still be NaN), before either warpgroup's
        // products read them
        uint8_t* b_blocks = stage + kWgABytes + 2 * wg * kWgMnBlock;
        uint8_t* mine[3] = {a_block, b_blocks, b_blocks + kWgMnBlock};
#pragma unroll
        for (int blk = 0; blk < 3; ++blk) {
          uint4* rows = reinterpret_cast<uint4*>(mine[blk]);
          for (int i = live * 8 + threadIdx.x % 128; i < kWgBK * 8; i += 128)
            rows[i] = make_uint4(0, 0, 0, 0);
        }
        hopper::fence_proxy_async();
        hopper::named_barrier_sync(1, 256);   // both consumer warpgroups
      }
      const uint32_t a_rows = hopper::smem_u32(a_block);
      const uint32_t b_tile = hopper::smem_u32(stage + kWgABytes);
      hopper::fence_regs(acc[0]);
      hopper::fence_regs(acc[1]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(a_rows + kk * 16 * 128);   // 16 rows a k-step
#pragma unroll
        for (int h = 0; h < 2; ++h)
          hopper::wgmma_ss_n128<T, true, true>(
              acc[h], da, hopper::desc_sw128(b_tile + 2 * h * kWgMnBlock + kk * 16 * 128, kWgMnBlock),
              ks > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      if (ks > 0) {   // the previous stage's products are done: release it
        hopper::wgmma_wait<1>();
        hopper::mbar_arrive(&empty[(it - 1) % kWgStages]);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    if (k_iters > 0) {
      hopper::mbar_arrive(&empty[(it - 1) % kWgStages]);
    } else {   // an expert with no rows: dW is zero
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    }
    store_acc(out + static_cast<int64_t>(tile.expert) * K * N, acc, tile.m0 + 64 * wg, K,
              tile.n0, N, warp, lane);
  }
}

constexpr int kSimtBM = 64;
constexpr int kSimtBN = 64;
constexpr int kSimtBK = 16;

// fp32 row-grouped product (forward and dx): FMAs on CUDA cores, 64 x 64
// tiles, 4 x 4 outputs per thread at a stride of 16 so that shared-memory
// reads of a warp hit distinct banks. With kTransB the B tile is read along
// w[e]'s rows (the contraction), 16 consecutive threads on one row, and
// Bs's rows are padded by one word so those threads' stores hit distinct
// banks.
template <bool kTransB>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_fp32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                             const int* __restrict__ offsets, float* __restrict__ out, int Kc,
                             int Nout, int E) {
  int expert, row0, row1;
  if (!find_tile<kSimtBM>(offsets, E, blockIdx.x, expert, row0, row1)) return;
  const int n0 = blockIdx.y * kSimtBN;
  __shared__ float As[kSimtBK][kSimtBM + 4];            // [k][row]
  __shared__ float Bs[kSimtBK][kSimtBN + (kTransB ? 1 : 0)];  // [k][column]
  const float* wE = w + static_cast<int64_t>(expert) * Kc * Nout;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Kc; k0 += kSimtBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kThreads;
      const int ar = c >> 4, ak = c & 15;
      const int gr = row0 + ar, gk = k0 + ak;
      As[ak][ar] = (gr < row1 && gk < Kc) ? a[static_cast<int64_t>(gr) * Kc + gk] : 0.f;
      if (kTransB) {
        const int gn = n0 + ar;
        Bs[ak][ar] = (gn < Nout && gk < Kc) ? wE[static_cast<int64_t>(gn) * Kc + gk] : 0.f;
      } else {
        const int br = c >> 6, bn = c & 63;
        const int gbk = k0 + br, gn = n0 + bn;
        Bs[br][bn] = (gbk < Kc && gn < Nout) ? wE[static_cast<int64_t>(gbk) * Nout + gn] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= row1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < Nout) out[static_cast<int64_t>(row) * Nout + col] = acc[i][j];
    }
  }
}

// fp32 dW: block (K tile, N tile, expert), 64 x 64 outputs, the expert's
// rows walked 16 at a time; both tiles are read along rows of [R, .].
__global__ void __launch_bounds__(kThreads)
    grouped_tgmm_fp32_kernel(const float* __restrict__ xs, const float* __restrict__ dy,
                             const int* __restrict__ offsets, float* __restrict__ out, int K,
                             int N) {
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kSimtBM, n0 = blockIdx.y * kSimtBN;
  const int row0 = offsets[e];
  const int row1 = max(offsets[e + 1], row0);
  __shared__ float As[kSimtBK][kSimtBM];  // [row][m]
  __shared__ float Bs[kSimtBK][kSimtBN];  // [row][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r0 = row0; r0 < row1; r0 += kSimtBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 6, col = c & 63;
      const int gr = r0 + r;
      As[r][col] = (gr < row1 && m0 + col < K) ? xs[static_cast<int64_t>(gr) * K + m0 + col]
                                               : 0.f;
      Bs[r][col] = (gr < row1 && n0 + col < N) ? dy[static_cast<int64_t>(gr) * N + n0 + col]
                                               : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* outE = out + static_cast<int64_t>(e) * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) outE[static_cast<int64_t>(m) * N + col] = acc[i][j];
    }
  }
}

// The wgmma kernel: tensor maps of a [R, Kc] (boxes of 128 rows x 64) and of
// w [E, Kc, Nout] (forward: boxes of 64 contraction rows x 64 columns) or
// [E, Nout, Kc] (dx: boxes of 256 output columns x 64), then a persistent
// grid of at most one block per SM.
template <typename T, bool kTransB>
cudaError_t launch_grouped_wgmma(const void* a, const void* w, const void* offsets, void* out,
                                 int R, int Kc, int Nout, int E, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  using u64 = cuuint64_t;
  const u64 kc = static_cast<u64>(Kc), nout = static_cast<u64>(Nout);
  const u64 a_dims[2] = {kc, static_cast<u64>(R)}, a_strides[1] = {kc * 2};
  const cuuint32_t a_box[2] = {kWgBK, kWgBM};
  const u64 b_dims[3] = {kTransB ? kc : nout, kTransB ? nout : kc, static_cast<u64>(E)};
  const u64 b_strides[2] = {b_dims[0] * 2, kc * nout * 2};
  const cuuint32_t b_box[3] = {64, kTransB ? static_cast<cuuint32_t>(kWgBN) : 64u, 1};
  CUtensorMap ta, tb;
  if (!hopper::make_map(&ta, a, f16, 2, a_dims, a_strides, a_box) ||
      !hopper::make_map(&tb, w, f16, 3, b_dims, b_strides, b_box))
    return cudaErrorInvalidValue;
  auto kernel = grouped_gemm_wgmma<T, kTransB>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // at most ceil(R / 128) + E row tiles (one ragged tile per expert)
  const long long tiles =
      static_cast<long long>((R + kWgBM - 1) / kWgBM + E) * ((Nout + kWgBN - 1) / kWgBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kWgThreads, kWgSmemBytes, stream>>>(ta, tb, static_cast<const int*>(offsets),
                                                     static_cast<T*>(out), Kc, Nout, E);
  return cudaGetLastError();
}

// The dW kernel: tensor maps of xs [R, K] and dy [R, N] (boxes of 64
// columns x 64 rows), the experts' order in shared memory after the ring,
// then a persistent grid of at most one block per SM.
template <typename T>
cudaError_t launch_tgmm_wgmma(const void* xs, const void* dy, const void* offsets, void* out,
                              int R, int K, int N, int E, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  using u64 = cuuint64_t;
  const u64 a_dims[2] = {static_cast<u64>(K), static_cast<u64>(R)};
  const u64 a_strides[1] = {static_cast<u64>(K) * 2};
  const u64 b_dims[2] = {static_cast<u64>(N), static_cast<u64>(R)};
  const u64 b_strides[1] = {static_cast<u64>(N) * 2};
  const cuuint32_t box[2] = {64, kWgBK};
  CUtensorMap ta, tb;
  if (!hopper::make_map(&ta, xs, f16, 2, a_dims, a_strides, box) ||
      !hopper::make_map(&tb, dy, f16, 2, b_dims, b_strides, box))
    return cudaErrorInvalidValue;
  const int smem = kWgSmemBytes + 4 * E;
  auto kernel = grouped_tgmm_wgmma<T>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long tiles = static_cast<long long>(E) * ((K + kWgBM - 1) / kWgBM) *
                          ((N + kWgBN - 1) / kWgBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kWgThreads, smem, stream>>>(ta, tb, static_cast<const int*>(offsets),
                                             static_cast<T*>(out), K, N, E);
  return cudaGetLastError();
}

template <bool kTransB>
cudaError_t launch_grouped_fp32(const void* a, const void* w, const void* offsets, void* out,
                                int R, int Kc, int Nout, int E, cudaStream_t stream) {
  const dim3 grid((R + kSimtBM - 1) / kSimtBM + E, (Nout + kSimtBN - 1) / kSimtBN);
  grouped_gemm_fp32_kernel<kTransB><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<const int*>(offsets), static_cast<float*>(out), Kc, Nout, E);
  return cudaGetLastError();
}

bool bad_dims(int R, int K, int N, int E) {
  return R <= 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8;
}

// The kernels, in the order of the launch tally (ds_grouped_kernel_launches).
enum Kernel { kFwdSimt, kFwdWgmma, kDxSimt, kDxWgmma, kDwSimt, kDwWgmma, kNumKernels };
long long g_launches[kNumKernels] = {};

// The kernel that `which` (0 forward, 1 dx, 2 dW) launches for dtype code
// `dtype` (0 fp32, 1 fp16, 2 bf16); -1 for a dtype the product does not take
// (the backward takes fp32 and bf16). bf16 / fp16 take the wgmma kernels
// (forward and dx at every row count, a decode round's included), fp32 the
// SIMT ones (see the header).
int grouped_route(int which, int dtype) {
  if (which < 0 || which > 2 || dtype < 0 || dtype > 2 || (which > 0 && dtype == 1)) return -1;
  return (which == 0 ? kFwdSimt : which == 1 ? kDxSimt : kDwSimt) + (dtype == 0 ? 0 : 1);
}

// Launches the row-grouped product (forward: kTransB false; dx: true) on the
// route's kernel and counts it.
template <bool kTransB>
cudaError_t row_grouped(int dtype, const void* a, const void* w, const void* offsets, void* out,
                        int R, int Kc, int Nout, int E, cudaStream_t s) {
  const int k = grouped_route(kTransB ? 1 : 0, dtype);
  const int simt = kTransB ? kDxSimt : kFwdSimt;
  cudaError_t e;
  if (k == simt) {
    e = launch_grouped_fp32<kTransB>(a, w, offsets, out, R, Kc, Nout, E, s);
  } else if (k == simt + 1) {
    if constexpr (kTransB)   // dx takes bf16 only
      e = launch_grouped_wgmma<__nv_bfloat16, true>(a, w, offsets, out, R, Kc, Nout, E, s);
    else
      e = dtype == 1
              ? launch_grouped_wgmma<__half, false>(a, w, offsets, out, R, Kc, Nout, E, s)
              : launch_grouped_wgmma<__nv_bfloat16, false>(a, w, offsets, out, R, Kc, Nout, E, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (e == cudaSuccess) ++g_launches[k];
  return e;
}

}  // namespace

// Forward. xs [R, K], w [E, K, N], group_offsets [E + 1] int32, out [R, N],
// all on the device and contiguous; dtype 0 = fp32, 1 = fp16, 2 = bf16.
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int ds_grouped_matmul(const void* xs, const void* w, const void* group_offsets,
                                 void* out, int R, int K, int N, int E, int dtype,
                                 void* stream) {
  if (bad_dims(R, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(row_grouped<false>(dtype, xs, w, group_offsets, out, R, K, N, E,
                                             static_cast<cudaStream_t>(stream)));
}

// dx (megablox gmm with transpose_rhs). dy [R, N], w [E, K, N],
// group_offsets [E + 1] int32, out [R, K]; dtype 0 = fp32, 2 = bf16.
extern "C" int ds_grouped_matmul_dx(const void* dy, const void* w, const void* group_offsets,
                                    void* out, int R, int K, int N, int E, int dtype,
                                    void* stream) {
  if (bad_dims(R, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(row_grouped<true>(dtype, dy, w, group_offsets, out, R, N, K, E,
                                            static_cast<cudaStream_t>(stream)));
}

// dW (megablox tgmm). xs [R, K], dy [R, N], group_offsets [E + 1] int32,
// out [E, K, N], every expert's slice written (zeros for an empty one);
// dtype 0 = fp32, 2 = bf16.
extern "C" int ds_grouped_matmul_dw(const void* xs, const void* dy, const void* group_offsets,
                                    void* out, int R, int K, int N, int E, int dtype,
                                    void* stream) {
  if (bad_dims(R, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = grouped_route(2, dtype);
  cudaError_t err;
  if (k == kDwSimt) {
    const dim3 grid((K + kSimtBM - 1) / kSimtBM, (N + kSimtBN - 1) / kSimtBN, E);
    grouped_tgmm_fp32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(xs), static_cast<const float*>(dy),
        static_cast<const int*>(group_offsets), static_cast<float*>(out), K, N);
    err = cudaGetLastError();
  } else if (k == kDwWgmma) {   // bf16 only
    err = launch_tgmm_wgmma<__nv_bfloat16>(xs, dy, group_offsets, out, R, K, N, E, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err == cudaSuccess) ++g_launches[k];
  return static_cast<int>(err);
}

// The kernel (index into the launch tally's order: forward SIMT, wgmma; dx
// SIMT, wgmma; dW SIMT, wgmma) that `which` (0 forward, 1 dx, 2 dW)
// launches for dtype code `dtype`; -1 where the product does not take that
// dtype.
extern "C" int ds_grouped_route(int which, int dtype) { return grouped_route(which, dtype); }

// Launches so far of one kernel, in the order above; -1 past the end.
extern "C" long long ds_grouped_kernel_launches(int kernel) {
  return kernel >= 0 && kernel < kNumKernels ? g_launches[kernel] : -1;
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
