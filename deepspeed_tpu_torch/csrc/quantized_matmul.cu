// Weight-only quantized matrix product (W8A16) for Hopper (sm_90a). Built by
// deepspeed_tpu_torch/ops/cuda_build.py with nvcc into a shared library with
// a plain C interface, called through ctypes by
// deepspeed_tpu_torch/ops/quantized_matmul.py (quantized_matmul).
//
// Replaces the TPU kernel of deepspeed_tpu/ops/pallas/quantized_matmul.py
// (`_kernel`, :55-83, reached through `_quantized_matmul_local`'s
// pl.pallas_call at :149; public entry `quantized_matmul`):
//   out[m, n] = cast_out( sum_k x[m, k] * T(float(q[k, n]) * scale[k, n / G]) )
// with x [M, K] in T (bf16 or fp16), q [K, N] int8, scale [K, N / G] fp32,
// the dequantized weight rounded once to T (one fp32 multiply, one
// round-to-nearest-even, never fused with anything else), the products
// accumulated in fp32 and rounded once to the output dtype (bf16, fp16 or
// fp32). These are the TPU kernel's rounding points, and those of the
// dequantize-then-matmul route (`dense_dequant`) in the working dtype.
//
// What bounds it on the H100. Serving decodes a handful of rows (M = batch)
// against the whole weight: one Llama-2-7B gate_proj is 45.1 MB of int8 and
// 0.70 MB of scales read for 2 M K N operations, so decode is bound by HBM
// bytes (13.7 us at 3.35 TB/s for M = 4). A prefill chunk of 1024 rows does
// 92 GFLOP on the same bytes and is bound by the tensor cores (93 us at
// 989 TFLOP/s).
//
// Two kernels, chosen in the source by the row count (qmm_route, exported as
// ds_qmm_route; ds_qmm_kernel_launches counts what each call launched). Both
// are persistent and warp-specialised: a producer warp streams the int8
// weight by TMA (tensor maps over q [K, N] as bytes, boxes of 64 rows x 128
// columns, 128-byte swizzled) into a ring of stages whose `full` mbarrier
// also waits for the stage's scales (cp.async, one small [64 x groups] box
// per stage, reported to the barrier by cp.async.mbarrier.arrive) and for x's
// columns (TMA, 128-byte swizzled). A work item is (row tile, 256-column
// tile, K range); ops/quantized_matmul.py `plan` chooses the K split that
// spreads the items evenly over the card, and `work_items` mirrors the item
// order. With more than one split each item writes fp32 partial sums to a
// workspace and quantized_matmul_split_reduce adds them in split order and rounds
// once: no atomics, the result is deterministic.
//
//   - M <= 16, decode (bound by bytes): quantized_matmul_decode. Two blocks
//     per SM, four stages of 16 KB of int8 each; four consumer warps take 64
//     columns each. The product is computed transposed, out^T = W^T . x^T,
//     so that the weight is the 16-row A side of mma.sync m16n8k16 and the
//     rows of x pad to 8 (16 for M > 8), not to 16. A consumer reads int8
//     straight from the swizzled stage (8 bytes a row, 4 rows a k-step),
//     dequantizes in registers (bytes to fp32 by a byte permute and one
//     exact subtraction, then the fp32 scale multiply and the rounding to
//     T) and feeds the A fragments directly: no bf16 tile in shared memory
//     and no block-wide barrier per stage. Which 16 columns make an A tile
//     is free (each column is its own output), so a thread's 8 consecutive
//     columns are split over 4 A tiles and its 32-bit B fragments of x are
//     the pairs x[m][k], x[m][k + 1] of the mma's own k order.
//   - M > 16, prefill (bound by operations): quantized_matmul_wgmma, the
//     shape of grouped_gemm_wgmma (csrc/grouped_gemm.cu) as one group: one
//     block per SM, two consumer warpgroups of 64 rows x 256 columns
//     (wgmma m64n128k16, fp32 accumulators), a 3-stage ring of x's [128 x
//     64] tile, q's [64 x 256] int8 tile and its scales. The consumers
//     dequantize each landed stage into the stage's own bf16/fp16 B tile,
//     in hopper.cuh's 128-byte-swizzled MN-major layout (8 columns, one 16
//     byte store, per thread and row), fence it to the async proxy and meet
//     at one named barrier; the dequantization of stage n + 1 then runs
//     while stage n's wgmma is in flight. The int8 tile crosses HBM at half
//     the bytes of a bf16 weight.
// Rows past M, K past the item's range and columns past N read TMA's zeros
// (scales past the range read zeros too) and are never stored, so any
// M >= 1, K % 8 == 0 (16-byte rows of x), N % 16 == 0 and G % 16 == 0 are
// taken, fp16 or bf16 activations and fp32, fp16 or bf16 outputs, on either
// kernel. Products of two bf16/fp16 values are exact in fp32, so the
// kernels and the plain version differ only in the order of the fp32 sums.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kBN = 256;                  // columns of a work item
constexpr int kBK = 64;                   // contraction rows per stage
constexpr int kBox = 128;                 // columns of one int8 TMA box (128 bytes a row)
constexpr int kMaxGroups = kBN / 16 + 1;  // scale groups 256 columns can touch (G >= 16)
constexpr uint32_t kQBytes = kBK * kBN;                 // int8 tile: 16 KB
constexpr uint32_t kScaleBytes = 5 * 1024;              // [kBK][kMaxGroups] fp32, padded
static_assert(kBK * kMaxGroups * 4 <= kScaleBytes, "scale box");

template <typename O>
struct Out;

template <>
struct Out<float> {
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
  static __device__ __forceinline__ float cast(float x) { return x; }
};

template <>
struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
  static __device__ __forceinline__ __nv_bfloat16 cast(float x) { return __float2bfloat16_rn(x); }
};

template <>
struct Out<__half> {
  static __device__ __forceinline__ void store2(__half* p, float x, float y) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  }
  static __device__ __forceinline__ __half cast(float x) { return __float2half_rn(x); }
};

// Eight int8 weights (two 32-bit words, lowest byte first) times their
// scale in fp32: each byte b becomes 2^23 + (b + 128) by a byte permute
// into an fp32 word, and subtracting 2^23 + 128 leaves float(q) exactly;
// the one multiply by the scale is the TPU kernel's w8 * s.
__device__ __forceinline__ void dequant8(uint2 w, float sc, float (&v)[8]) {
  const uint32_t lo = w.x ^ 0x80808080u, hi = w.y ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = (__uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7440u | j)) - 8388736.f) * sc;
    v[4 + j] = (__uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7440u | j)) - 8388736.f) * sc;
  }
}

// Byte offset of (row r, byte column c) in a stage's int8 tile: two boxes of
// 64 rows x 128 bytes, 16-byte chunk j of row r stored at chunk j ^ (r % 8).
__device__ __forceinline__ uint32_t q_offset(int r, int c) {
  const int cb = c % kBox;
  return (c / kBox) * (kBK * kBox) + r * kBox + ((((cb >> 4) ^ r) & 7) << 4) + (cb & 15);
}

struct Item {
  int m0, n0, kbeg, kend, sp;
};

// Work item i: split sp = i / tiles, then the tile, column tile by column
// tile, the row tiles of one column tile next to each other (they share
// its weight in L2). ops/quantized_matmul.py work_items mirrors this.
__device__ __forceinline__ Item qmm_item(int i, int n_mt, int n_ct, int K, int k_split, int bm) {
  const int tiles = n_mt * n_ct;
  const int t = i % tiles;
  Item it;
  it.sp = i / tiles;
  it.n0 = (t / n_mt) * kBN;
  it.m0 = (t % n_mt) * bm;
  it.kbeg = it.sp * k_split;
  it.kend = min(it.kbeg + k_split, K);
  return it;
}

// The producer's loads of one stage: lane 0 the TMA boxes of q (and x),
// every lane its share of the stage's scales [kBK rows][groups of the
// tile] by cp.async, then one arrival each on `full` once they land. Rows
// at or past kend read zero scales.
__device__ __forceinline__ void load_scales(float* ss, const float* __restrict__ scale, int k0,
                                            int kend, int g0, int ng, int NG, int lane,
                                            uint64_t* full) {
  for (int e = lane; e < kBK * ng; e += 32) {
    const int r = e / ng, j = e - r * ng;
    const bool ok = k0 + r < kend;
    hopper::cp_async4(ss + r * kMaxGroups + j,
                      ok ? scale + static_cast<int64_t>(k0 + r) * NG + g0 + j : scale, ok);
  }
  hopper::cp_async_arrive_noinc(full);
}

// The scale groups a tile's columns n0 .. min(n0 + 256, N) - 1 touch.
__device__ __forceinline__ int tile_groups(int n0, int N, int G) {
  return (min(n0 + kBN, N) - 1) / G - n0 / G + 1;
}

// ---------------------------------------------------------------------------
// decode: M <= 16, mma.sync on register-dequantized weights
// ---------------------------------------------------------------------------

constexpr int kDecStages = 4;
constexpr int kDecThreads = 5 * 32;       // four consumer warps, then the producer warp
constexpr uint32_t kDecXBytes = 16 * kBK * 2;   // x [16 rows][64] in T, swizzled
constexpr uint32_t kDecStageBytes = kQBytes + kDecXBytes + kScaleBytes;
constexpr int kDecSmem = 1024 + kDecStages * kDecStageBytes + 16 * kDecStages;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// out (or the split's fp32 partial) for items i = blockIdx.x, + gridDim.x,
// ... of 256 columns each (qmm_item with one row tile of up to 16 rows).
// NT n8 tiles of x rows: 1 for M <= 8, 2 for M <= 16. Consumer warp w owns
// columns n0 + 64 w .. + 63; lane (g = lane / 4, t = lane % 4) holds the 8
// columns n0 + 64 w + 8 g + j. mma tile i (0-3) takes A row g = column
// 8 g + 2 i and A row g + 8 = column 8 g + 2 i + 1, the mma's k index the
// stage's row 16 kk + k; its accumulator c0, c1 (c2, c3) is that A row's
// output for x rows 8 nt + 2 t and + 1.
template <typename T, typename O, int NT>
__global__ void __launch_bounds__(kDecThreads, 2)
    quantized_matmul_decode(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tx, const float* __restrict__ scale,
                            O* __restrict__ out, float* __restrict__ partial, int M, int K, int N,
                            int G, int n_items, int k_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                               ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kDecStages * kDecStageBytes);
  uint64_t* empty = full + kDecStages;
  const int n_ct = (N + kBN - 1) / kBN;
  const int NG = N / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDecStages; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);   // lane 0's expect_tx, every lane's scales
      hopper::mbar_init(&empty[s], 4);       // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {   // the producer warp
    int it = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item item = qmm_item(i, 1, n_ct, K, k_split, 16);
      const int g0 = item.n0 / G, ng = tile_groups(item.n0, N, G);
      for (int k0 = item.kbeg; k0 < item.kend; k0 += kBK, ++it) {
        const int s = it % kDecStages;
        if (it >= kDecStages) hopper::mbar_wait(&empty[s], (it / kDecStages - 1) & 1);
        uint8_t* st = stages + s * kDecStageBytes;
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&full[s], kQBytes + kDecXBytes);
          hopper::tma_load_2d(st, &tq, &full[s], item.n0, k0);
          hopper::tma_load_2d(st + kBK * kBox, &tq, &full[s], item.n0 + kBox, k0);
          hopper::tma_load_2d(st + kQBytes, &tx, &full[s], k0, 0);
        }
        load_scales(reinterpret_cast<float*>(st + kQBytes + kDecXBytes), scale, k0, item.kend,
                    g0, ng, NG, lane, &full[s]);
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int col = 64 * warp + 8 * g;   // this thread's 8 columns within the tile
  int it = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const Item item = qmm_item(i, 1, n_ct, K, k_split, 16);
    const int sj = (item.n0 + col) / G - item.n0 / G;   // this thread's scale group
    float acc[NT][4][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][a][e] = 0.f;

    for (int k0 = item.kbeg; k0 < item.kend; k0 += kBK, ++it) {
      const int s = it % kDecStages;
      hopper::mbar_wait(&full[s], (it / kDecStages) & 1);
      const uint8_t* st = stages + s * kDecStageBytes;
      const uint8_t* sx = st + kQBytes;
      const float* ss = reinterpret_cast<const float*>(st + kQBytes + kDecXBytes);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // the thread's k rows of the mma: 2t, 2t + 1, 2t + 8, 2t + 9
        float v[4][8];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int r = 16 * kk + 2 * t + (h & 1) + 8 * (h >> 1);
          const uint2 w = *reinterpret_cast<const uint2*>(st + q_offset(r, col));
          dequant8(w, ss[r * kMaxGroups + sj], v[h]);
        }
        uint32_t b[NT][2];   // x[m][16 kk + 2t .. +1] and [16 kk + 8 + 2t .. +1], m = 8 nt + g
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int m = 8 * nt + g;
#pragma unroll
          for (int hb = 0; hb < 2; ++hb)
            b[nt][hb] = *reinterpret_cast<const uint32_t*>(
                sx + m * 128 + ((((2 * kk + hb) ^ m) & 7) << 4) + 4 * t);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          uint32_t af[4];
          af[0] = hopper::pack2<T>(v[0][2 * a], v[1][2 * a]);
          af[1] = hopper::pack2<T>(v[0][2 * a + 1], v[1][2 * a + 1]);
          af[2] = hopper::pack2<T>(v[2][2 * a], v[3][2 * a]);
          af[3] = hopper::pack2<T>(v[2][2 * a + 1], v[3][2 * a + 1]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) Mma<T>::run(acc[nt][a], af, b[nt][0], b[nt][1]);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    const int n = item.n0 + col;
    if (n >= N) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * nt + 2 * t + e;
        if (m >= M) continue;
        const int64_t at = static_cast<int64_t>(m) * N + n;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if (partial != nullptr)
            Out<float>::store2(partial + static_cast<int64_t>(item.sp) * M * N + at + 2 * a,
                               acc[nt][a][e], acc[nt][a][2 + e]);
          else
            Out<O>::store2(out + at + 2 * a, acc[nt][a][e], acc[nt][a][2 + e]);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// prefill: M > 16, wgmma on a dequantized B tile
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;                 // rows per tile: two consumer warpgroups of 64
constexpr int kWgStages = 3;
constexpr int kWgThreads = 3 * 128;        // two consumer warpgroups, then the producer's
constexpr uint32_t kWgABytes = kWgBM * kBK * 2;           // x [128 rows][64]
constexpr uint32_t kWgBBytes = kBK * kBN * 2;             // dequantized [64 k][256 n]
constexpr uint32_t kWgMnBlock = kBK * 128;                // one [64 k][64 n] column block
constexpr uint32_t kWgStageBytes = kWgABytes + kQBytes + kScaleBytes + kWgBBytes;
constexpr int kWgSmem = 1024 + kWgStages * kWgStageBytes + 16 * kWgStages;
constexpr int kWgProducerRegs = 40, kWgConsumerRegs = 232;

template <typename T, typename O>
__global__ void __launch_bounds__(kWgThreads, 1)
    quantized_matmul_wgmma(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tx, const float* __restrict__ scale,
                           O* __restrict__ out, float* __restrict__ partial, int M, int K, int N,
                           int G, int n_items, int k_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                               ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  const int n_mt = (M + kWgBM - 1) / kWgBM, n_ct = (N + kBN - 1) / kBN;
  const int NG = N / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    hopper::setmaxnreg_dec<kWgProducerRegs>();
    if (warp != 8) return;
    int it = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item item = qmm_item(i, n_mt, n_ct, K, k_split, kWgBM);
      const int g0 = item.n0 / G, ng = tile_groups(item.n0, N, G);
      for (int k0 = item.kbeg; k0 < item.kend; k0 += kBK, ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) hopper::mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
        uint8_t* st = stages + s * kWgStageBytes;
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&full[s], kWgABytes + kQBytes);
          hopper::tma_load_2d(st, &tx, &full[s], k0, item.m0);
          hopper::tma_load_2d(st + kWgABytes, &tq, &full[s], item.n0, k0);
          hopper::tma_load_2d(st + kWgABytes + kBK * kBox, &tq, &full[s], item.n0 + kBox, k0);
        }
        load_scales(reinterpret_cast<float*>(st + kWgABytes + kQBytes), scale, k0, item.kend, g0,
                    ng, NG, lane, &full[s]);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<kWgConsumerRegs>();

  const int wg = warp / 4, tid = threadIdx.x;   // tid 0-255 over both warpgroups
  const int cc = tid % 32;                      // dequantize: 8 columns 8 cc .. 8 cc + 7
  float acc[2][64];
  int it = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const Item item = qmm_item(i, n_mt, n_ct, K, k_split, kWgBM);
    const int sj = (item.n0 + 8 * cc) / G - item.n0 / G;
    int ks = 0;
    for (int k0 = item.kbeg; k0 < item.kend; k0 += kBK, ++it, ++ks) {
      const int s = it % kWgStages;
      hopper::mbar_wait(&full[s], (it / kWgStages) & 1);
      uint8_t* st = stages + s * kWgStageBytes;
      const uint8_t* sq = st + kWgABytes;
      const float* ss = reinterpret_cast<const float*>(st + kWgABytes + kQBytes);
      uint8_t* sb = st + kWgABytes + kQBytes + kScaleBytes;
      // dequantize: row r = tid / 32 + 8 j, columns 8 cc .. + 7 into column
      // block cc / 8 of the MN-major B tile, chunk (cc % 8) ^ (r % 8)
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const int r = tid / 32 + 8 * j;
        float v[8];
        dequant8(*reinterpret_cast<const uint2*>(sq + q_offset(r, 8 * cc)),
                 ss[r * kMaxGroups + sj], v);
        *reinterpret_cast<uint4*>(sb + (cc / 8) * kWgMnBlock + r * 128 +
                                  ((((cc & 7) ^ r) & 7) << 4)) =
            make_uint4(hopper::pack2<T>(v[0], v[1]), hopper::pack2<T>(v[2], v[3]),
                       hopper::pack2<T>(v[4], v[5]), hopper::pack2<T>(v[6], v[7]));
      }
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1, 256);   // the whole B tile is written

      const uint32_t a_rows = hopper::smem_u32(st) + 64 * wg * 128;
      const uint32_t b_tile = hopper::smem_u32(sb);
      hopper::fence_regs(acc[0]);
      hopper::fence_regs(acc[1]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(a_rows + kk * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          hopper::wgmma_ss_n128<T, true>(
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
    if (ks > 0) hopper::mbar_arrive(&empty[(it - 1) % kWgStages]);

    // acc[h][4 j + e]: row m0 + 64 wg + 16 (warp % 4) + lane / 4 + 8 (e / 2),
    // column n0 + 128 h + 8 j + 2 (lane % 4) + e % 2
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = item.m0 + 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * e2;
      if (row >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = item.n0 + 128 * h + 8 * j + 2 * (lane % 4);
          if (n >= N) continue;
          const int64_t at = static_cast<int64_t>(row) * N + n;
          if (partial != nullptr)
            Out<float>::store2(partial + static_cast<int64_t>(item.sp) * M * N + at,
                               acc[h][4 * j + 2 * e2], acc[h][4 * j + 2 * e2 + 1]);
          else
            Out<O>::store2(out + at, acc[h][4 * j + 2 * e2], acc[h][4 * j + 2 * e2 + 1]);
        }
    }
  }
}

// out[i] = cast(sum over splits, in split order, of partial[s][i])
template <typename O>
__global__ void quantized_matmul_split_reduce(const float* __restrict__ partial,
                                              O* __restrict__ out, int64_t count, int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += partial[s * count + i];
    out[i] = Out<O>::cast(sum);
  }
}

// The kernels, in the order of the launch tally (ds_qmm_kernel_launches).
enum Kernel { kDecodeMma, kPrefillWgmma, kNumKernels };
long long g_launches[kNumKernels] = {};
constexpr int kDecodeMaxRows = 16;

// The kernel for M rows: mma.sync on register-dequantized weights up to 16
// rows (decode, bound by bytes), wgmma on a dequantized tile above (bound by
// operations); -1 for M < 1. Both take every dtype and shape of the header.
int qmm_route(int M) {
  if (M < 1) return -1;
  return M <= kDecodeMaxRows ? kDecodeMma : kPrefillWgmma;
}

// Tensor maps: q [K, N] int8 as bytes in boxes of 64 rows x 128 columns
// (remembered: a weight is read at one address call after call); x [M, K]
// in T in boxes of 64 columns x `x_rows` rows; both 128-byte swizzled,
// reading zeros past an edge.
template <typename T>
bool make_maps(CUtensorMap* tq, CUtensorMap* tx, const void* q, const void* x, int M, int K,
               int N, int x_rows) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  using u64 = cuuint64_t;
  const u64 q_dims[2] = {static_cast<u64>(N), static_cast<u64>(K)};
  const u64 q_strides[1] = {static_cast<u64>(N)};
  const cuuint32_t q_box[2] = {kBox, kBK};
  const u64 x_dims[2] = {static_cast<u64>(K), static_cast<u64>(M)};
  const u64 x_strides[1] = {static_cast<u64>(K) * 2};
  const cuuint32_t x_box[2] = {kBK, static_cast<cuuint32_t>(x_rows)};
  return hopper::make_map_of_cached(tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q_dims, q_strides,
                                    q_box) &&
         hopper::make_map(tx, x, f16, 2, x_dims, x_strides, x_box);
}

template <typename T, typename O>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, void* workspace,
                   int M, int K, int N, int G, int splits, int k_split, cudaStream_t stream) {
  const int k = qmm_route(M);
  const bool decode = k == kDecodeMma;
  CUtensorMap tq, tx;
  if (!make_maps<T>(&tq, &tx, q, x, M, K, N, decode ? 16 : kWgBM)) return cudaErrorInvalidValue;
  const int sms = hopper::sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  cudaError_t e;
  const int n_ct = (N + kBN - 1) / kBN;
  const int n_mt = decode ? 1 : (M + kWgBM - 1) / kWgBM;
  const int n_items = n_mt * n_ct * splits;
  float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  const float* sc = static_cast<const float*>(scale);
  O* o = static_cast<O*>(out);
  if (decode) {
    auto kernel = M <= 8 ? quantized_matmul_decode<T, O, 1> : quantized_matmul_decode<T, O, 2>;
    e = hopper::allow_smem(reinterpret_cast<const void*>(kernel), kDecSmem);
    if (e != cudaSuccess) return e;
    const int grid = n_items < 2 * sms ? n_items : 2 * sms;
    kernel<<<grid, kDecThreads, kDecSmem, stream>>>(tq, tx, sc, o, partial, M, K, N, G, n_items,
                                                    k_split);
  } else {
    auto kernel = quantized_matmul_wgmma<T, O>;
    e = hopper::allow_smem(reinterpret_cast<const void*>(kernel), kWgSmem);
    if (e != cudaSuccess) return e;
    const int grid = n_items < sms ? n_items : sms;
    kernel<<<grid, kWgThreads, kWgSmem, stream>>>(tq, tx, sc, o, partial, M, K, N, G, n_items,
                                                  k_split);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ++g_launches[k];
  if (splits == 1) return cudaSuccess;
  const int64_t count = static_cast<int64_t>(M) * N;
  const int64_t wanted = (count + 255) / 256;
  const int blocks = static_cast<int>(wanted < 4096 ? wanted : 4096);
  quantized_matmul_split_reduce<O><<<blocks, 256, 0, stream>>>(partial, o, count, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_out(int out_dtype, const void* x, const void* q, const void* scale, void* out,
                       void* workspace, int M, int K, int N, int G, int splits, int k_split,
                       cudaStream_t stream) {
  switch (out_dtype) {
    case 0:
      return launch<T, float>(x, q, scale, out, workspace, M, K, N, G, splits, k_split, stream);
    case 1:
      return launch<T, __half>(x, q, scale, out, workspace, M, K, N, G, splits, k_split, stream);
    case 2:
      return launch<T, __nv_bfloat16>(x, q, scale, out, workspace, M, K, N, G, splits, k_split,
                                      stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out [M, N] = x [M, K] @ dequant(q [K, N] int8, scale [K, N / G] fp32),
// all on the device, contiguous and 16-byte aligned. x_dtype 1 = fp16,
// 2 = bf16 (also the dtype the weight is rounded to); out_dtype 0 = fp32,
// 1 = fp16, 2 = bf16. K is split into `splits` ranges of k_split (a
// multiple of 64) contraction rows, whose fp32 partial sums go to
// `workspace` [splits, M, N] when splits > 1. Needs K % 8 == 0, N % G == 0
// and G % 16 == 0. Launches the route's kernel (qmm_route) on `stream` and
// returns the launch's cudaError_t (0 = success).
extern "C" int ds_quantized_matmul(const void* x, const void* q, const void* scale, void* out,
                                   void* workspace, int M, int K, int N, int group_size,
                                   int x_dtype, int out_dtype, int splits, int k_split,
                                   void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || group_size <= 0 || K % 8 || group_size % 16 ||
      N % group_size || splits <= 0 || k_split <= 0 || k_split % kBK ||
      static_cast<int64_t>(splits - 1) * k_split >= K ||
      static_cast<int64_t>(splits) * k_split < K || (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 1:
      return static_cast<int>(launch_out<__half>(out_dtype, x, q, scale, out, workspace, M, K, N,
                                                 group_size, splits, k_split, s));
    case 2:
      return static_cast<int>(launch_out<__nv_bfloat16>(out_dtype, x, q, scale, out, workspace,
                                                        M, K, N, group_size, splits, k_split, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernel (0 decode mma.sync, 1 prefill wgmma: the launch tally's order)
// that M rows launch; -1 for M < 1.
extern "C" int ds_qmm_route(int M) { return qmm_route(M); }

// Launches so far of one kernel, in the order above; -1 past the end.
extern "C" long long ds_qmm_kernel_launches(int kernel) {
  return kernel >= 0 && kernel < kNumKernels ? g_launches[kernel] : -1;
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
