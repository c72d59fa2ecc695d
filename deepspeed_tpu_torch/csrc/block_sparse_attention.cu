// Block-sparse attention forward for Hopper (sm_90a). Built by
// deepspeed_tpu_torch/ops/cuda_build.py with nvcc into a shared library with
// a plain C interface, called through ctypes by
// deepspeed_tpu_torch/ops/block_sparse_attention.py (sparse_mha_fwd, and the
// autograd Function behind sparse_mha).
//
// Replaces the TPU kernel of deepspeed_tpu/ops/pallas/block_sparse_attention.py:
//   ds_block_sparse_fwd <- _kernel (pl.pallas_call in _forward, :136; sparse_mha :144)
// Same function: q, k, v [B, H, S, D] (any strides with a contiguous last
// dim), D <= 256, S = nq * block; cols [H, nq, C] and counts [H, nq] int32 are
// the compacted layout (compact_layout): query block iq of head h visits key
// blocks cols[h, iq, 0 .. counts[h, iq]) in ascending order. Logits
// s = (q . k in fp32) * scale; with causal, a key at a later global position
// than the query takes the finite NEG_INF = -1e9, inside enabled blocks only
// (compact_layout already dropped the blocks above the diagonal). The online
// softmax keeps m and l in fp32 per query row, with m starting at NEG_INF;
// p = exp(s - m_cur), with m_cur the running maximum after the whole key
// block, is rounded to v's dtype before the PV product, whose sums are fp32;
// acc = acc * alpha + P.V. The output is acc / l where l > 0, else exactly 0
// (a query block whose counts is 0). The output is [B, H, S, D] contiguous.
//
// What bounds it on the H100: 4 * D operations per visible (query, key) pair
// against reading q, k, v and writing o once. At Llama-2-7B attention width
// (32 heads of 128) with Fixed(block 64, unidirectional) at S = 16384 that is
// 574 GFLOP over 0.54 GB: bound by operations, 0.58 ms at 989 TFLOP/s.
//
// Two kernels, chosen in the source by dtype, block and head width
// (sparse_route, exported as ds_sparse_route; ds_sparse_kernel_launches
// counts what each call launched):
//
// bf16 / fp16 at block 64 or 128 and head width up to 128:
// block_sparse_fwd_wgmma, on the tensor cores. The TPU grid runs (b, h, iq,
// j) with j, the enabled-block slot, innermost and sequential, carrying m,
// l and acc in VMEM scratch across j; the K/V index maps read cols so that
// only enabled blocks are fetched. Here a work item is 64 query rows of one
// query block (block 128: two items) of one head of one batch row, owned
// by one consumer warpgroup, with one producer warp:
//   - a persistent grid (as many blocks as fit, 2 per SM at block 64) walks
//     the work items in descending counts order (work_order in
//     ops/block_sparse_attention.py, computed once per layout on the host
//     beside compact_layout): a BigBird global row, which visits every key
//     block, starts first instead of setting the tail;
//   - the producer's lane 0 loads the item's Q rows once (a double-buffered
//     slot) and streams K and V of the key blocks cols[h, iq, 0 .. counts)
//     through a 2-stage TMA ring; a key tile is exactly one layout block,
//     so the running maximum, and with it the rounding of p, is the TPU
//     kernel's, block by block;
//   - the consumer computes S = Q.K^T with wgmma m64n64k16 (fp32
//     accumulators), masks and runs the online softmax in registers (alpha
//     after each whole block), rounds p to v's dtype as wgmma's register A
//     operand, and adds P.V with V read MN-major through the transpose bit;
//   - q, k and v are read in place through 4-D tensor maps built from their
//     strides (16-byte aligned; the wrapper copies inputs that are not).
// Tensor-core q.k sums differ from the plain version's fp32 sums in the last
// bits, so a p lying at a rounding boundary may round the other way
// (tests/flash_rounding.py sparse_flip_slack bounds that, and sparse_probe
// holds the rounding point itself with no slack).
//
// fp32, blocks other than 64 and 128, and head widths over 128:
// block_sparse_fwd_kernel, SIMT fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak), kept by the declared route: TF32 is not the TPU kernel's
// arithmetic, a key tile must be one whole layout block, and a 256-wide
// output would need 128 more accumulator registers a thread. One thread
// block of 256 threads (a 16 x 16 grid) owns BQ query rows of one query
// block of one head of one batch row, reads its own counts and cols, and
// loops over its enabled key blocks:
//   - a key block is staged whole (BK >= block rows, the rows past block are
//     absent: p = 0), so the running maximum is the TPU kernel's;
//   - q rows, then K and V in turn, are staged in shared memory as fp32 rows
//     padded by 4 floats; each thread computes a 4 x 4 (or smaller) block of
//     the score tile with float4 shared loads, row max and sum are shuffles
//     over the 16 lanes of a row, and the output accumulators live in
//     registers, columns tx * 4 + 64 c;
//   - blocks up to 128 and D up to 256 need up to 183 KB of shared memory,
//     taken as dynamic shared memory after cudaFuncSetAttribute; the launch
//     error is returned to the wrapper, which raises.
// Blocks above 128 are refused here (the wrapper raises before launching).

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

// Mirrored field by field by _SparseParams in ops/block_sparse_attention.py.
struct DsSparseParams {
  const void* q;
  const void* k;
  const void* v;
  const int* cols;                   // [H, nq, C] int32
  const int* counts;                 // [H, nq] int32
  const int* order;                  // [H * nq] int32: h * nq + iq, descending counts (wgmma)
  void* out;                         // [B, H, S, D] contiguous
  long long q_sb, q_sh, q_ss;        // element strides of q over (B, H, S)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int B, H, S, dh, block, nq, C, causal;
  float scale;
};

namespace {

using Params = DsSparseParams;

constexpr int kThreads = 256;        // a 16 x 16 thread grid
constexpr int kPad = 4;              // floats of padding after each smem row
constexpr float kNegInf = -1e9f;     // the TPU kernel's finite mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the TPU kernel's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// max / sum over the 16 lanes that share a score row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

// Rows [r0, r0 + n) of one head (src points at sequence position 0 of that
// head, positions s_s elements apart) into smem [R][D + kPad] as fp32; rows
// >= n and columns >= dh are zero.
template <typename T, int R, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, long long s_s,
                                          int r0, int n, int dh) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r < n && d < dh) x = to_float(src[static_cast<long long>(r0 + r) * s_s + d]);
    dst[r * (D + kPad) + d] = x;
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d]  (A, B: smem [..][D + kPad])
template <int RI, int CJ, int D>
__device__ __forceinline__ void product_nt(float (&acc)[RI][CJ], const float* A, const float* B,
                                           int ty, int tx) {
  constexpr int LD = D + kPad;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][c] += sum_k P[ty + 16 i][k] * V[k][col(c)], col(c) = tx * 4 + 64 * (c / 4) + c % 4
// (P: smem [..][K + kPad], V: smem [K][D + kPad])
template <int RI, int K, int D>
__device__ __forceinline__ void product_nn(float (&acc)[RI][D / 16], const float* P, const float* V,
                                           int ty, int tx) {
  constexpr int LDP = K + kPad, LDV = D + kPad, NC4 = D / 64;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 p[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * LDP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c4 = 0; c4 < NC4; ++c4) {
        const float4 v = *reinterpret_cast<const float4*>(V + (k + kk) * LDV + tx * 4 + 64 * c4);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float pk = kk == 0 ? p[i].x : kk == 1 ? p[i].y : kk == 2 ? p[i].z : p[i].w;
          acc[i][c4 * 4 + 0] = fmaf(pk, v.x, acc[i][c4 * 4 + 0]);
          acc[i][c4 * 4 + 1] = fmaf(pk, v.y, acc[i][c4 * 4 + 1]);
          acc[i][c4 * 4 + 2] = fmaf(pk, v.z, acc[i][c4 * 4 + 2]);
          acc[i][c4 * 4 + 3] = fmaf(pk, v.w, acc[i][c4 * 4 + 3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward: grid (nq * query tiles per block, H, B)
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
constexpr int smem_floats() { return (BQ + BK) * (D + kPad) + BQ * (BK + kPad); }

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) block_sparse_fwd_kernel(const Params p) {
  constexpr int RI = BQ / 16, CJ = BK / 16, NC = D / 16, LDP = BK + kPad;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [BQ][D + kPad]
  float* sX = sQ + BQ * (D + kPad);              // [BK][D + kPad]: K, then V
  float* sP = sX + BK * (D + kPad);              // [BQ][BK + kPad]

  const int tiles = (p.block + BQ - 1) / BQ;     // query tiles per query block
  const int iq = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * BQ;      // first row of the tile in its block
  const int n_rows = min(BQ, p.block - r0);
  const int q0 = iq * p.block + r0;              // global position of the tile's row 0
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const long long row = static_cast<long long>(h) * p.nq + iq;
  const int count = p.counts[row];
  const int* cols = p.cols + row * p.C;
  load_rows<T, BQ, D>(sQ, q, p.q_ss, q0, n_rows, p.dh);

  float m[RI], l[RI], o[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }

  for (int j = 0; j < count; ++j) {
    const int k0 = cols[j] * p.block;
    __syncthreads();   // the previous block's readers of sX and sP are done
    load_rows<T, BK, D>(sX, k, p.k_ss, k0, p.block, p.dh);
    __syncthreads();
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) s[i][jj] = 0.f;
    product_nt<RI, CJ, D>(s, sQ, sX, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        const int kc = tx + 16 * jj;
        float x = s[i][jj] * p.scale;
        if (kc >= p.block) x = -INFINITY;                    // no such key: p = 0
        else if (p.causal && qpos < k0 + kc) x = kNegInf;    // masked, as on the TPU
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) {
        const float pj = expf(s[i][jj] - m_new);
        sum += pj;
        sP[(ty + 16 * i) * LDP + tx + 16 * jj] = round_to<T>(pj);   // p.astype(v.dtype)
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();   // everyone is done with K
    load_rows<T, BK, D>(sX, v, p.v_ss, k0, p.block, p.dh);
    __syncthreads();
    product_nn<RI, BK, D>(o, sP, sX, ty, tx);
  }

  T* out = static_cast<T*>(p.out) + (static_cast<long long>(b) * p.H + h) * p.S * p.dh;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= n_rows) continue;
    T* dst = out + static_cast<long long>(q0 + r) * p.dh;
    const bool live = l[i] > 0.f;            // counts == 0 leaves l == 0: exact zeros
    const float inv = live ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx * 4 + 64 * (c / 4) + c % 4;
      if (d < p.dh) dst[d] = from_float<T>(live ? o[i][c] * inv : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16 forward on the tensor cores: persistent, warp-specialised,
// wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kTcStages = 2;          // K / V ring depth
constexpr int kQSlots = 2;            // Q of the current and the next work item
constexpr int kBlockBytes = 128;      // bytes per row of a 64-column block
constexpr int kTcThreads = 128 + 32;  // one consumer warpgroup, one producer warp

// Shared memory: kQSlots Q tiles of 64 rows, then kTcStages stages of K and
// V (BK rows each), each DS / 64 column blocks of 128-byte swizzled rows,
// then the barriers (q_full, q_empty, full, empty); +1024 for aligning the
// base.
template <int DS, int BK>
constexpr int tc_smem_bytes() {
  return 1024 + kQSlots * 64 * DS * 2 + kTcStages * 2 * BK * DS * 2 +
         8 * 2 * (kQSlots + kTcStages);
}

// Work item t of the launch: order[t / (B * halves)] is h * nq + iq, and the
// items of one (h, iq) follow each other, batch row by batch row, each in
// `halves` = block / 64 items of 64 query rows. ops/block_sparse_attention.py
// work_items mirrors this.
struct SparseItem {
  int b, h, hq, q0;
};

__device__ __forceinline__ SparseItem sparse_item(const Params& p, int t) {
  const int halves = p.block / 64;
  const int per = p.B * halves;
  SparseItem it;
  it.hq = __ldg(p.order + t / per);
  const int r = t % per;
  it.b = r / halves;
  it.h = it.hq / p.nq;
  it.q0 = (it.hq % p.nq) * p.block + (r % halves) * 64;
  return it;
}

// S[n] = Q . K^T for the BK / 64 key chunks of a staged tile: Q the 64 rows
// at q_tile (column blocks 64 * 128 bytes apart), K at k_tile (column blocks
// BK * 128 bytes apart), both K-major.
template <typename T, int DS, int BK>
__device__ __forceinline__ void issue_qk(float (&acc)[BK / 64][32], uint32_t q_tile,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DS / 16; ++kk) {
    const uint64_t da = hopper::desc_sw128(q_tile + (kk / 4) * 64 * kBlockBytes + (kk % 4) * 32);
#pragma unroll
    for (int n = 0; n < BK / 64; ++n)
      hopper::wgmma_ss<T>(acc[n], da,
                          hopper::desc_sw128(k_tile + (kk / 4) * BK * kBlockBytes +
                                             n * 64 * kBlockBytes + (kk % 4) * 32),
                          kk > 0);
  }
}

// acc[c] += P . V for the DS / 64 column blocks of a staged [BK][DS] tile V
// read MN-major; P is pa[BK / 16] register fragments in v's dtype.
template <typename T, int DS, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[DS / 64][32], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < DS / 64; ++c)
      hopper::wgmma_rs_mn<T>(acc[c], pa[kk],
                             hopper::desc_sw128(v_tile + c * BK * kBlockBytes + kk * 16 * kBlockBytes));
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N][32]) {
#pragma unroll
  for (int i = 0; i < N; ++i) hopper::fence_regs(r[i]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The forward over work items t = blockIdx.x, + gridDim.x, ... (sparse_item).
// Key tiles of BK = block keys, head width staged as DS columns. Thread
// layout: warps 0-3 the consumer warpgroup, warp 4 the producer (lane 0).
// Accumulator element (n, 4 j + e) of a thread is query row q0 + 16 warp +
// lane / 4 + 8 (e / 2), key k0 + 64 n + 8 j + 2 (lane % 4) + e % 2.
template <typename T, int DS, int BK>
__global__ void __launch_bounds__(kTcThreads, BK == 64 ? 2 : 1)
    block_sparse_fwd_wgmma(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv) {
  constexpr int NDC = DS / 64, NS = BK / 64;
  constexpr uint32_t kQBytes = NDC * 64 * kBlockBytes;
  constexpr uint32_t kKBytes = NDC * BK * kBlockBytes;
  constexpr uint32_t kStageBytes = 2 * kKBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_slots = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                ~static_cast<uintptr_t>(1023));
  uint8_t* stages = q_slots + kQSlots * kQBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stages + kTcStages * kStageBytes);
  uint64_t* q_empty = q_full + kQSlots;
  uint64_t* full = q_empty + kQSlots;
  uint64_t* empty = full + kTcStages;
  const int n_items = p.B * p.H * p.nq * (p.block / 64);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQSlots; ++s) {
      hopper::mbar_init(&q_full[s], 1);
      hopper::mbar_init(&q_empty[s], 128);
    }
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {   // the producer
    if (lane != 0) return;
    int it = 0, qi = 0;
    for (int t = blockIdx.x; t < n_items; t += gridDim.x, ++qi) {
      const SparseItem item = sparse_item(p, t);
      const int qs = qi % kQSlots;
      if (qi >= kQSlots) hopper::mbar_wait(&q_empty[qs], (qi / kQSlots - 1) & 1);
      uint8_t* qt = q_slots + qs * kQBytes;
      hopper::mbar_arrive_expect_tx(&q_full[qs], kQBytes);
#pragma unroll
      for (int c = 0; c < NDC; ++c)
        hopper::tma_load_4d(qt + c * 64 * kBlockBytes, &tq, &q_full[qs], 64 * c, item.q0, item.h,
                            item.b);
      const int count = __ldg(p.counts + item.hq);
      const int* cols = p.cols + static_cast<long long>(item.hq) * p.C;
      for (int j = 0; j < count; ++j, ++it) {
        const int s = it % kTcStages;
        if (it >= kTcStages) hopper::mbar_wait(&empty[s], (it / kTcStages - 1) & 1);
        const int k0 = __ldg(cols + j) * p.block;
        uint8_t* st = stages + s * kStageBytes;
        hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
#pragma unroll
        for (int c = 0; c < NDC; ++c) {
          hopper::tma_load_4d(st + c * BK * kBlockBytes, &tk, &full[s], 64 * c, k0, item.h, item.b);
          hopper::tma_load_4d(st + kKBytes + c * BK * kBlockBytes, &tv, &full[s], 64 * c, k0,
                              item.h, item.b);
        }
      }
    }
    return;
  }

  T* out = static_cast<T*>(p.out);
  int it = 0, qi = 0;
  for (int t = blockIdx.x; t < n_items; t += gridDim.x, ++qi) {
    const SparseItem item = sparse_item(p, t);
    const int qs = qi % kQSlots;
    const int count = __ldg(p.counts + item.hq);
    const int* cols = p.cols + static_cast<long long>(item.hq) * p.C;
    const int rq[2] = {item.q0 + 16 * warp + lane / 4, item.q0 + 16 * warp + lane / 4 + 8};
    const uint32_t q_tile = hopper::smem_u32(q_slots + qs * kQBytes);
    float o[NDC][32];
#pragma unroll
    for (int c = 0; c < NDC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    hopper::mbar_wait(&q_full[qs], (qi / kQSlots) & 1);
    for (int j = 0; j < count; ++j, ++it) {
      const int s = it % kTcStages;
      const int k0 = __ldg(cols + j) * p.block;
      const uint32_t k_tile = hopper::smem_u32(stages) + s * kStageBytes;
      const uint32_t v_tile = k_tile + kKBytes;
      hopper::mbar_wait(&full[s], (it / kTcStages) & 1);

      float x[NS][32];
      __syncwarp();
      fence_all(x);
      hopper::wgmma_fence();
      issue_qk<T, DS, BK>(x, q_tile, k_tile);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_all(x);
      if (j == count - 1) hopper::mbar_arrive(&q_empty[qs]);   // Q is read for the last time

      // s = q.k * scale; causal: NEG_INF where the key comes after the query
      const bool diagonal = p.causal && k0 + BK - 1 > item.q0;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 64 * n + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          x[n][i] = diagonal && key > rq[(i % 4) / 2] ? kNegInf : x[n][i] * p.scale;
        }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x[n][i]);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float m_new = fmaxf(m[e], quad_max(mx[e]));
        alpha[e] = expf(m[e] - m_new);
        m[e] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          x[n][i] = expf(x[n][i] - m[(i % 4) / 2]);
          sum[(i % 4) / 2] += x[n][i];
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) l[e] = alpha[e] * l[e] + quad_sum(sum[e]);
#pragma unroll
      for (int c = 0; c < NDC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i % 4) / 2];

      uint32_t pa[BK / 16][4];   // p.astype(v.dtype), as the register A fragments
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int n = kk / 4, jj = 8 * (kk % 4);
        pa[kk][0] = hopper::pack2<T>(x[n][jj + 0], x[n][jj + 1]);
        pa[kk][1] = hopper::pack2<T>(x[n][jj + 2], x[n][jj + 3]);
        pa[kk][2] = hopper::pack2<T>(x[n][jj + 4], x[n][jj + 5]);
        pa[kk][3] = hopper::pack2<T>(x[n][jj + 6], x[n][jj + 7]);
      }
      __syncwarp();
      fence_all(o);
      hopper::wgmma_fence();
      issue_pv<T, DS, BK>(o, pa, v_tile);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_all(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) hopper::fence_regs(pa[kk]);
      hopper::mbar_arrive(&empty[s]);
    }
    if (count == 0) hopper::mbar_arrive(&q_empty[qs]);

    // counts == 0 leaves l == 0: exact zeros
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      T* dst = out + ((static_cast<long long>(item.b) * p.H + item.h) * p.S + rq[e]) * p.dh;
#pragma unroll
      for (int c = 0; c < NDC; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int d = 64 * c + 8 * jj + 2 * (lane % 4) + u;
            if (d < p.dh) dst[d] = from_float<T>(l[e] > 0.f ? o[c][4 * jj + 2 * e + u] / l[e] : 0.f);
          }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D, int BQ, int BK>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = block_sparse_fwd_kernel<T, D, BQ, BK>;
  const size_t smem = static_cast<size_t>(smem_floats<D, BQ, BK>()) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.nq * ((p.block + BQ - 1) / BQ), p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Key tiles hold a whole key block: BK is the block rounded up to 16, 32, 64
// or 128. Query tiles are min(BK, 64) rows, 32 at BK 128 with D 256 so that
// the staged rows fit in 227 KB.
template <typename T, int D>
cudaError_t dispatch_block(const Params& p, cudaStream_t s) {
  if (p.block <= 16) return launch<T, D, 16, 16>(p, s);
  if (p.block <= 32) return launch<T, D, 32, 32>(p, s);
  if (p.block <= 64) return launch<T, D, 64, 64>(p, s);
  if (p.block <= 128) return launch<T, D, (D > 128 ? 32 : 64), 128>(p, s);
  return cudaErrorInvalidValue;
}

// Head widths up to 256 round up to a staged width of 64, 128 or 256; the
// extra columns are zero.
template <typename T>
cudaError_t simt(const Params& p, cudaStream_t s) {
  if (p.dh <= 64) return dispatch_block<T, 64>(p, s);
  if (p.dh <= 128) return dispatch_block<T, 128>(p, s);
  return dispatch_block<T, 256>(p, s);
}

// The tensor-core kernel: tensor maps of q (64-row boxes), k and v (boxes
// of one layout block) over [B, H, S, dh] with their strides, then a
// persistent grid of as many blocks as fit on the card.
template <typename T, int DS, int BK>
cudaError_t tensor_core(const Params& p, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  if (p.order == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!hopper::make_head_map(&tq, p.q, f16, p.B, p.S, p.H, p.dh, p.q_sb, p.q_ss, p.q_sh, 64) ||
      !hopper::make_head_map(&tk, p.k, f16, p.B, p.S, p.H, p.dh, p.k_sb, p.k_ss, p.k_sh, BK) ||
      !hopper::make_head_map(&tv, p.v, f16, p.B, p.S, p.H, p.dh, p.v_sb, p.v_ss, p.v_sh, BK))
    return cudaErrorInvalidValue;
  auto kernel = block_sparse_fwd_wgmma<T, DS, BK>;
  constexpr int smem = tc_smem_bytes<DS, BK>();
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTcThreads, smem);
  if (e != cudaSuccess) return e;
  const long long items = static_cast<long long>(p.B) * p.H * p.nq * (p.block / 64);
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(items < slots ? items : slots);
  kernel<<<grid, kTcThreads, smem, stream>>>(p, tq, tk, tv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t wgmma(const Params& p, cudaStream_t s) {
  if (p.dh <= 64) return p.block == 64 ? tensor_core<T, 64, 64>(p, s) : tensor_core<T, 64, 128>(p, s);
  return p.block == 64 ? tensor_core<T, 128, 64>(p, s) : tensor_core<T, 128, 128>(p, s);
}

// The kernels, in the order of the launch tally (ds_sparse_kernel_launches).
enum Kernel { kFwdSimt, kFwdWgmma, kNumKernels };
long long g_launches[kNumKernels] = {};

// The kernel for dtype code `dtype` (0 fp32, 1 fp16, 2 bf16), block and head
// width, or -1 for what neither takes: bf16 / fp16 at block 64 or 128 and
// head width up to 128 on the tensor cores (a key tile is one whole layout
// block; 256 columns of output would not fit the consumer's registers),
// everything else on the SIMT kernel (see the header).
int sparse_route(int dtype, int block, int dh) {
  if (dtype < 0 || dtype > 2 || dh <= 0 || dh > 256 || block <= 0 || block > 128 || block % 8)
    return -1;
  return dtype != 0 && (block == 64 || block == 128) && dh <= 128 ? kFwdWgmma : kFwdSimt;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, k, v and the output
// share it). Launches the route's kernel and returns a cudaError_t code.
extern "C" int ds_block_sparse_fwd(const Params* p, int dtype, void* stream) {
  if (p->B == 0 || p->H == 0 || p->S == 0) return cudaSuccess;
  if (p->block <= 0 || p->block % 8 || p->S != p->nq * p->block || p->C < 1)
    return cudaErrorInvalidValue;
  const int k = sparse_route(dtype, p->block, p->dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (k == kFwdWgmma) {
    e = dtype == 1 ? wgmma<__half>(*p, s) : wgmma<__nv_bfloat16>(*p, s);
  } else if (k == kFwdSimt) {
    e = dtype == 0 ? simt<float>(*p, s) : dtype == 1 ? simt<__half>(*p, s)
                                                     : simt<__nv_bfloat16>(*p, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (e == cudaSuccess) ++g_launches[k];
  return e;
}

// The kernel (0 SIMT, 1 wgmma: the launch tally's order) that dtype code
// `dtype`, `block` and head width `dh` launch; -1 where none takes them.
extern "C" int ds_sparse_route(int dtype, int block, int dh) {
  return sparse_route(dtype, block, dh);
}

// Launches so far of one kernel, in the order above; -1 past the end.
extern "C" long long ds_sparse_kernel_launches(int kernel) {
  return kernel >= 0 && kernel < kNumKernels ? g_launches[kernel] : -1;
}

extern "C" const char* ds_block_sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
