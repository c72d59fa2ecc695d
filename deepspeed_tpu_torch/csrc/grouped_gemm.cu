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
// tile. Here blocks run in no order, so:
//   - forward and dx: the grid is sized for the worst case without reading
//     the group sizes on the host: ceil(R / 128) + E row tiles by
//     ceil(Nout / 128) column tiles. Each block walks group_offsets on the
//     device (E is small: a linear scan), finds its (expert, rows) and exits
//     when it has none. A forward or backward costs no host sync;
//   - dW: a grid of K tiles x N tiles x E. Each block contracts over its
//     expert's ragged row range offsets[e]:offsets[e+1] in steps of 32 rows;
//     an expert with no rows leaves its accumulators at zero and stores
//     them. A skewed routing (7/8 of the rows in one expert) makes that
//     expert's blocks long; they are many (K/128 x N/128 of them), so the
//     card stays full, but the tail is theirs: splitting the rows over
//     blocks is later work;
//   - tiles of 128 x 128 outputs, 8 warps of 64 x 32; the contraction is
//     walked in steps of 32 through a 3-stage ring of cp.async copies into
//     shared memory (rows padded by 16 bytes so ldmatrix reads hit distinct
//     banks);
//   - bf16/fp16 products run on the tensor cores with mma.sync m16n8k16
//     (fp32 accumulators); products of two bf16/fp16 values are exact in
//     fp32, so kernel and plain version differ only in summation order
//     before the one rounding. Every operand stays in the JAX layout and the
//     fragments are built by ldmatrix: the forward's B, w[e] [K, N], is
//     transposed into the mma fragment by ldmatrix.trans; dx contracts along
//     w's contiguous axis, so its B tile is [N rows][K] in shared memory and
//     plain ldmatrix reads it; dW reads both operands from row-major [R, .]
//     matrices, so both its A (xs^T) and B (dy) fragments come from
//     ldmatrix.trans;
//   - ragged edges are masked in the kernel: rows past the group's end and
//     columns past the matrix are zero-filled by cp.async (src-size 0) and
//     never stored, so nothing is padded. K and N must be multiples of 8
//     (16-byte copies);
//   - fp32 inputs take separate SIMT kernels (64 x 64 tiles, FMAs on CUDA
//     cores): TF32 tensor cores would round the inputs. The backward kernels
//     take bf16 and fp32, megablox's dtypes.
// This is the simple, correct first kernel: wgmma, TMA, warp specialisation,
// a smaller row tile for decode and split rows for dW are later work.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;            // rows per block tile
constexpr int kBN = 128;            // columns per block tile
constexpr int kBK = 32;             // contraction per pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;       // 8 warps: 2 (rows) x 4 (columns)
// rows padded by 16 bytes (80 and 272 bytes): the 8 rows one ldmatrix reads
// start in 8 different 16-byte bank groups
constexpr int kPadA = kBK + 8;      // tiles stored [128][32 of the contraction]
constexpr int kPadB = kBN + 8;      // tiles stored [32 of the contraction][128]
constexpr int kTileRows = kBM * kPadA;
constexpr int kTileCols = kBK * kPadB;

// Shared memory of the row-grouped kernel: A [128][32] and B [32][128]
// (forward) or [128][32] (dx) per stage.
constexpr int grouped_smem_bytes(bool trans_b) {
  return kStages * (kTileRows + (trans_b ? kTileRows : kTileCols)) * 2;
}
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
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
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ void store2(__half* p, float x, float y) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  }
};

// Ldmatrix fragment loads for warp tile (wm, wn) at contraction step ks of a
// stage. A is [16 rows][16] per mma tile (a0..a3: rows 0-7 / 8-15 by
// contraction 0-7 / 8-15), B [16][8] per tile (b0, b1: contraction 0-7 /
// 8-15); one x4 load gives two n8 tiles of B.
//
// A tile stored [row][contraction]: plain ldmatrix.
__device__ __forceinline__ void load_a_rows(uint32_t (&af)[4][4], const void* tile, int ks,
                                            int wm, int lane, int elem) {
  const char* t = static_cast<const char*>(tile);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
    ldmatrix_x4(af[mi], t + ((wm * 64 + mi * 16 + (lane & 15)) * kPadA + ks +
                             (lane >> 4) * 8) * elem);
}

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

// B tile stored [column][contraction] (dx's w[e] read along K): plain
// ldmatrix; matrices (n 0-7, c 0-7), (n 0-7, c 8-15), (n 8-15, c 0-7), ...
__device__ __forceinline__ void load_b_rows(uint32_t (&bf)[4][2], const void* tile, int ks,
                                            int wn, int lane, int elem) {
  const char* t = static_cast<const char*>(tile);
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    uint32_t r[4];
    ldmatrix_x4(r, t + ((wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kPadA + ks +
                        ((lane >> 3) & 1) * 8) * elem);
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

// Row-grouped product on the tensor cores: out [R, Nout] = a [R, Kc] @
// op(w[e(r)]), with w[e] stored [Kc, Nout] (forward, kTransB false) or
// [Nout, Kc] (dx, kTransB true). Block (row tile, column tile); warp
// (wm, wn) owns rows wm*64 .. +64 and columns wn*32 .. +32 of the block tile
// as 4 x 4 mma tiles of 16 x 8.
template <typename T, bool kTransB>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_gemm_mma_kernel(const T* __restrict__ a, const T* __restrict__ w,
                            const int* __restrict__ offsets, T* __restrict__ out, int Kc,
                            int Nout, int E) {
  int expert, row0, row1;
  if (!find_tile<kBM>(offsets, E, blockIdx.x, expert, row0, row1)) return;
  const int n0 = blockIdx.y * kBN;
  constexpr int kStageB = kTransB ? kTileRows : kTileCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);  // [kStages][kBM][kPadA]
  T* sB = sA + kStages * kTileRows;        // [kStages][kBK][kPadB] or [kBN][kPadA]
  const T* wE = w + static_cast<int64_t>(expert) * Kc * Nout;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;

  // one stage: A 128 rows x 32 and B 32 x 128 columns, 512 16-byte chunks
  // each, two of each per thread
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    T* sa = sA + stage * kTileRows;
    T* sb = sB + stage * kStageB;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int ar = c >> 2, ak = (c & 3) * 8;
      const int gr = row0 + ar, gk = k0 + ak;
      const bool a_ok = gr < row1 && gk < Kc;
      cp_async16(sa + ar * kPadA + ak, a_ok ? a + static_cast<int64_t>(gr) * Kc + gk : a, a_ok);
      if (kTransB) {  // w[e] row n holds the contraction: [column][contraction]
        const int gn = n0 + ar;
        const bool b_ok = gn < Nout && gk < Kc;
        cp_async16(sb + ar * kPadA + ak, b_ok ? wE + static_cast<int64_t>(gn) * Kc + gk : w,
                   b_ok);
      } else {
        const int br = c >> 4, bn = (c & 15) * 8;
        const int gbk = k0 + br, gn = n0 + bn;
        const bool b_ok = gbk < Kc && gn < Nout;
        cp_async16(sb + br * kPadB + bn, b_ok ? wE + static_cast<int64_t>(gbk) * Nout + gn : w,
                   b_ok);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int k_tiles = (Kc + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    // stage kt has landed for every thread, and every warp is done with the
    // stage the next copy overwrites (the one computed at kt - 1)
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();
    const T* sa = sA + (kt % kStages) * kTileRows;
    const T* sb = sB + (kt % kStages) * kStageB;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
      load_a_rows(af, sa, ks, wm, lane, sizeof(T));
      if (kTransB)
        load_b_rows(bf, sb, ks, wn, lane, sizeof(T));
      else
        load_b_cols(bf, sb, ks, wn, lane, sizeof(T));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) Tc<T>::mma(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  store_tile(out, acc, row0, row1, n0, Nout, wm, wn, lane);
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

template <typename T, bool kTransB>
cudaError_t launch_grouped(const void* a, const void* w, const void* offsets, void* out,
                           int R, int Kc, int Nout, int E, cudaStream_t stream) {
  // above 48 KB of shared memory only as dynamic shared memory, once opted in;
  // the attribute is per device, so it is set before every launch
  constexpr int smem = grouped_smem_bytes(kTransB);
  const cudaError_t attr = cudaFuncSetAttribute(
      grouped_gemm_mma_kernel<T, kTransB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((R + kBM - 1) / kBM + E, (Nout + kBN - 1) / kBN);
  grouped_gemm_mma_kernel<T, kTransB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w), static_cast<const int*>(offsets),
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

}  // namespace

// Forward. xs [R, K], w [E, K, N], group_offsets [E + 1] int32, out [R, N],
// all on the device and contiguous; dtype 0 = fp32, 1 = fp16, 2 = bf16.
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int ds_grouped_matmul(const void* xs, const void* w, const void* group_offsets,
                                 void* out, int R, int K, int N, int E, int dtype,
                                 void* stream) {
  if (bad_dims(R, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_grouped_fp32<false>(xs, w, group_offsets, out, R, K, N, E, s);
      break;
    case 1:
      err = launch_grouped<__half, false>(xs, w, group_offsets, out, R, K, N, E, s);
      break;
    case 2:
      err = launch_grouped<__nv_bfloat16, false>(xs, w, group_offsets, out, R, K, N, E, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dx (megablox gmm with transpose_rhs). dy [R, N], w [E, K, N],
// group_offsets [E + 1] int32, out [R, K]; dtype 0 = fp32, 2 = bf16.
extern "C" int ds_grouped_matmul_dx(const void* dy, const void* w, const void* group_offsets,
                                    void* out, int R, int K, int N, int E, int dtype,
                                    void* stream) {
  if (bad_dims(R, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_grouped_fp32<true>(dy, w, group_offsets, out, R, N, K, E, s);
      break;
    case 2:
      err = launch_grouped<__nv_bfloat16, true>(dy, w, group_offsets, out, R, N, K, E, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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
  return static_cast<int>(err);
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
