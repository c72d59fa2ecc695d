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
// the host, so no product costs a host sync. Three kernels, chosen in the
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
//   - bf16 dW: grouped_tgmm_mma_kernel, tiles of 128 x 128 outputs, 8 warps
//     of 64 x 32 on mma.sync m16n8k16, the rows walked in steps of 32
//     through a 3-stage ring of cp.async copies (rows padded by 16 bytes so
//     ldmatrix reads hit distinct banks). A grid of K tiles x N tiles x E,
//     each block contracting its expert's ragged row range (an expert with
//     no rows stores zeros); a skewed routing makes that expert's blocks
//     long;
//   - fp32: SIMT kernels (64 x 64 tiles, FMAs on CUDA cores): TF32 tensor
//     cores would round the inputs. The backward takes bf16 and fp32,
//     megablox's dtypes.
// Products of two bf16/fp16 values are exact in fp32, so every kernel and
// its plain version differ only in summation order before the one
// rounding. Ragged K and N edges read zeros (TMA's fill, or cp.async with
// src-size 0) and are never stored; K and N must be multiples of 8
// (16-byte rows). Later work: dW on wgmma with its rows split over blocks,
// and a TMA store epilogue.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;            // rows per block tile
constexpr int kBN = 128;            // columns per block tile
constexpr int kBK = 32;             // contraction per pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;       // 8 warps: 2 (rows) x 4 (columns)
// rows padded by 16 bytes (272 bytes): the 8 rows one ldmatrix reads start
// in 8 different 16-byte bank groups
constexpr int kPadB = kBN + 8;      // tiles stored [32 of the contraction][128]
constexpr int kTileCols = kBK * kPadB;
constexpr int kTgmmSmemBytes = kStages * 2 * kTileCols * 2;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

template <typename T>
struct Tc;

template <>
struct Tc<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
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

// Ldmatrix fragment loads for warp tile (wm, wn) at contraction step ks of a
// stage. A is [16 rows][16] per mma tile (a0..a3: rows 0-7 / 8-15 by
// contraction 0-7 / 8-15), B [16][8] per tile (b0, b1: contraction 0-7 /
// 8-15); one x4 load gives two n8 tiles of B.
//
// A tile stored [contraction][row] (dW's xs^T): ldmatrix.trans, matrices
// ordered (rows 0-7, c 0-7), (rows 8-15, c 0-7), (rows 0-7, c 8-15), ...
__device__ __forceinline__ void load_a_cols(uint32_t (&af)[4][4], const void* tile, int ks,
                                            int wm, int lane, int elem) {
  const char* t = static_cast<const char*>(tile);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
    ldmatrix_x4_trans(af[mi], t + ((ks + (lane & 7) + ((lane >> 4) << 3)) * kPadB +
                                   wm * 64 + mi * 16 + ((lane >> 3) & 1) * 8) * elem);
}

// B tile stored [contraction][column] (forward's w[e], dW's dy):
// ldmatrix.trans; matrices (c 0-7, n 0-7), (c 8-15, n 0-7), (c 0-7, n 8-15), ...
__device__ __forceinline__ void load_b_cols(uint32_t (&bf)[4][2], const void* tile, int ks,
                                            int wn, int lane, int elem) {
  const char* t = static_cast<const char*>(tile);
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, t + ((ks + (lane & 15)) * kPadB + wn * 32 + nj * 16 +
                              (lane >> 4) * 8) * elem);
    bf[2 * nj][0] = r[0];
    bf[2 * nj][1] = r[1];
    bf[2 * nj + 1][0] = r[2];
    bf[2 * nj + 1][1] = r[3];
  }
}

// Stores warp tile (wm, wn) of a 128 x 128 block tile whose first row is
// row0 (rows at or past row1 are skipped) and first column n0, into a
// row-major matrix of ld columns. Accumulator (mi, ni): rows g and g + 8,
// columns 2 tg and 2 tg + 1 of the 16 x 8 tile; ld % 8 == 0 keeps each pair
// inside or outside the matrix together.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ out, const float (&acc)[4][4][4],
                                           int row0, int row1, int n0, int ld, int wm, int wn,
                                           int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= row1) continue;
      T* orow = out + static_cast<int64_t>(row) * ld;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + tg * 2;
        if (col < ld) Tc<T>::store2(orow + col, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

// dW on the tensor cores: block (K tile, N tile, expert) computes
// out[e][m0 .. +128][n0 .. +128] = xs[rows_e, m-tile]^T @ dy[rows_e, n-tile],
// walking the expert's rows 32 at a time. Both operands are row-major [R, .]
// tiles stored [32 rows][128 columns]; an empty expert stores zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_tgmm_mma_kernel(const T* __restrict__ xs, const T* __restrict__ dy,
                            const int* __restrict__ offsets, T* __restrict__ out, int K,
                            int N) {
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int row0 = offsets[e];
  const int row1 = max(offsets[e + 1], row0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);  // [kStages][kBK][kPadB]: xs rows
  T* sB = sA + kStages * kTileCols;        // [kStages][kBK][kPadB]: dy rows
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;

  auto load_stage = [&](int stage, int kt) {
    const int r0 = row0 + kt * kBK;
    T* sa = sA + stage * kTileCols;
    T* sb = sB + stage * kTileCols;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 4, col = (c & 15) * 8;
      const int gr = r0 + r;
      const bool a_ok = gr < row1 && m0 + col < K;
      cp_async16(sa + r * kPadB + col,
                 a_ok ? xs + static_cast<int64_t>(gr) * K + m0 + col : xs, a_ok);
      const bool b_ok = gr < row1 && n0 + col < N;
      cp_async16(sb + r * kPadB + col,
                 b_ok ? dy + static_cast<int64_t>(gr) * N + n0 + col : dy, b_ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int k_tiles = (row1 - row0 + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();
    const T* sa = sA + (kt % kStages) * kTileCols;
    const T* sb = sB + (kt % kStages) * kTileCols;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
      load_a_cols(af, sa, ks, wm, lane, sizeof(T));
      load_b_cols(bf, sb, ks, wn, lane, sizeof(T));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) Tc<T>::mma(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  store_tile(out + static_cast<int64_t>(e) * K * N, acc, m0, K, n0, N, wm, wn, lane);
}

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

    // acc[h][4 j + e]: row 16 (warp % 4) + lane / 4 + 8 (e / 2) of the
    // warpgroup's 64, column 128 h + 8 j + 2 (lane % 4) + e % 2
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = tile.row0 + 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * e2;
      if (row >= tile.row1) continue;
      T* orow = out + static_cast<int64_t>(row) * Nout;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = tile.n0 + 128 * h + 8 * j + 2 * (lane % 4);
          if (col < Nout) Tc<T>::store2(orow + col, acc[h][4 * j + 2 * e2], acc[h][4 * j + 2 * e2 + 1]);
        }
    }
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
enum Kernel { kFwdSimt, kFwdWgmma, kDxSimt, kDxWgmma, kDwSimt, kDwMma, kNumKernels };
long long g_launches[kNumKernels] = {};

// The kernel that `which` (0 forward, 1 dx, 2 dW) launches for dtype code
// `dtype` (0 fp32, 1 fp16, 2 bf16); -1 for a dtype the product does not take
// (the backward takes fp32 and bf16). bf16 / fp16 forward and dx take the
// wgmma kernel at every row count, a decode round's included (see the
// header).
int grouped_route(int which, int dtype) {
  if (which < 0 || which > 2 || dtype < 0 || dtype > 2 || (which > 0 && dtype == 1)) return -1;
  if (which == 2) return dtype == 0 ? kDwSimt : kDwMma;
  return (which == 0 ? kFwdSimt : kDxSimt) + (dtype == 0 ? 0 : 1);
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
  cudaError_t err;
  switch (dtype) {
    case 0: {
      const dim3 grid((K + kSimtBM - 1) / kSimtBM, (N + kSimtBN - 1) / kSimtBN, E);
      grouped_tgmm_fp32_kernel<<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(xs), static_cast<const float*>(dy),
          static_cast<const int*>(group_offsets), static_cast<float*>(out), K, N);
      err = cudaGetLastError();
      break;
    }
    case 2: {
      err = cudaFuncSetAttribute(grouped_tgmm_mma_kernel<__nv_bfloat16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kTgmmSmemBytes);
      if (err != cudaSuccess) break;
      const dim3 grid((K + kBM - 1) / kBM, (N + kBN - 1) / kBN, E);
      grouped_tgmm_mma_kernel<__nv_bfloat16><<<grid, kThreads, kTgmmSmemBytes, s>>>(
          static_cast<const __nv_bfloat16*>(xs), static_cast<const __nv_bfloat16*>(dy),
          static_cast<const int*>(group_offsets), static_cast<__nv_bfloat16*>(out), K, N);
      err = cudaGetLastError();
      break;
    }
    default:
      err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) ++g_launches[grouped_route(2, dtype)];
  return static_cast<int>(err);
}

// The kernel (index into the launch tally's order: forward SIMT, wgmma; dx
// SIMT, wgmma; dW SIMT, mma.sync) that `which` (0 forward, 1 dx, 2 dW)
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
