// Paged (blocked-flash) attention for the ragged serving engine, for Hopper
// (sm_90a). Built by deepspeed_tpu_torch/ops/cuda_build.py with nvcc into a
// shared library with a plain C interface, called through ctypes by
// deepspeed_tpu_torch/ops/paged_attention.py::paged_mha.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/paged_attention.py
// (`_kernel`, launched by `_paged_mha_local` through pl.pallas_call; public
// entry `paged_mha`). Same function:
//   q [S, Q, H, Dh] against the k/v pools [NB, KV, bs, Dh] of one layer,
//   addressed through block_tables [S, MB]; GQA with rep = H / KV query heads
//   per kv head; key position kpos is visible to query token qi of sequence s
//   iff kpos <= seen[s] + qi (and kpos > seen[s] + qi - window with a
//   window); scores scaled by Dh^-0.5 (or softmax_scale); online softmax in
//   fp32 masked with the finite NEG_INF = -1e9; a row with no live key
//   returns 0. int8 pools carry per-token fp32 scales [NB, KV, 1, bs]: the
//   k-scale multiplies the score columns after QK, the v-scale multiplies
//   p's columns before PV. Rows qi >= q_len[s] (padding) are written as 0.
//
// What bounds it on the H100: decode (Q = 1) reads every live K/V byte once
// and does 4 * Dh flops per (query row, key), about one flop per byte for
// bf16 — far under the card's ~295 flop/byte ridge — so decode is bound by
// HBM bytes: sum over sequences of 2 * (seen + q) * KV * Dh * itemsize at
// 3.35 TB/s. Prefill chunks (Q in the hundreds) reuse each staged page
// across a tile of query rows and move toward the operations bound.
//
// Two kernels, chosen in the source by dtype, pool type, head width and
// block size (paged_route, exported as ds_paged_route;
// ds_paged_kernel_launches counts what each call launched):
//
// bf16 / fp16 q with fp pools at head width 64 or 128, block size a
// multiple of 16 that divides 64 or that 64 divides: paged_mha_wgmma, on the
// tensor cores. The TPU grid (seqs, kv_heads, max_blocks) runs in order on
// one core and carries the softmax state across the pages in VMEM; here a
// work item (thread block) is (sequence, kv head, a tile of 64 of the
// rep x Q rows, a key split), with one consumer warpgroup and one producer
// warp, two blocks per SM:
//   - tiles with no live row write zeros (or, split, nothing) and exit; a
//     live tile visits the 64-key tiles from the first key its rows can see
//     (window) to the last; with `splits` > 1, split i takes those of the
//     tiles [i * per, (i + 1) * per) of the block table's width (per = the
//     table's tiles / splits, the last split the rest), boundaries fixed by
//     the call's shape and not by the tile's live rows, so a query row's
//     output does not depend on the other rows of its tile: a tile past the
//     row's last key adds exact zeros (alpha 1, p 0) and a split with no key
//     of the row gets weight exp(NEG_INF - m) = 0 in the combine (the
//     wrapper's split count comes from S, KV, Q and the block table's width
//     alone, and splits only the one-row-tile items of a decode round that
//     would not fill the card several times: no host sync on seen);
//   - the producer's lane 0 reads the block table and streams each key
//     tile's pages by TMA (a 2-D map over the pool seen as [NB * KV * bs,
//     Dh], boxes of min(bs, 64) rows x 64 columns, 128-byte swizzled) into
//     a 3-stage ring of K and V (32 KB a stage at Dh 128);
//   - q's 64 rows stay in registers as wgmma's A fragments (rows (rep, Q)
//     as in the TPU kernel, gathered from q [S, Q, H, Dh] in place); S =
//     Q.K^T is wgmma m64n64k16 with K the K-major B, masked and scaled in
//     registers, the online softmax (m, l in fp32, the finite NEG_INF) runs
//     after each key tile, p is rounded once to v's dtype as the register A
//     of P.V, with V read MN-major through the transpose bit: the TPU
//     kernel's rounding points (q.k on the q dtype with fp32 sums, p
//     rounded to v's dtype, fp32 sums of P.V). p is taken against the
//     running maximum after each 64-key tile of the item (a page at block
//     size 64), and a split's against its own: where the TPU kernel's page
//     order puts the maximum elsewhere a p may round differently, within
//     tests/flash_rounding.py paged_flip_slack;
//   - one split writes o / l into q's layout; more write their unnormalised
//     fp32 o with m and l to a workspace, and paged_mha_combine merges them
//     in split order (deterministic) into the output.
//
// fp32, int8 pools, other head widths and block sizes: paged_mha_kernel,
// SIMT on the CUDA cores, kept by the declared route. One thread block owns
// (a tile of 16 query rows, one kv head, one sequence) and loops over that
// sequence's live pages itself:
//   - it reads its own block-table row, seen and q_len (no scalar prefetch),
//     and visits only pages from the first key its tile's lowest row can see
//     (window) to the last key its highest row can see: HBM reads are
//     O(seen), dead blocks are never touched;
//   - K and V pages are staged through shared memory 32 keys at a time with
//     16-byte loads, widened to fp32 (int8 pages stay int8 in HBM and are
//     dequantized here, as the TPU kernel does in VMEM);
//   - one lane per key computes the tile's scores with FMAs on CUDA cores;
//     the softmax state (m, l) lives in registers of the warp that owns the
//     row and the output accumulator in fp32 registers, 8 threads per row;
//     p is rounded once to v's dtype before P.V for bf16 / fp16 pools, as
//     the TPU kernel rounds it, and l sums the unrounded p; int8 pools keep
//     p in fp32 times the v scale (the TPU kernel's int8 arithmetic), and
//     for fp32 pools the rounding is the identity. p is taken against the
//     running maximum after each tile of 32 keys, where the TPU kernel
//     takes it per page: where the maximum lies elsewhere a p may round
//     differently, within tests/flash_rounding.py paged_flip_slack;
//   - the output is written straight into q's [S, Q, H, Dh] layout, with
//     none of the TPU wrapper's transposes.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;                  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                      // query rows per thread block
constexpr int kKeys = 32;                      // keys per shared tile, one per lane
constexpr int kRowsPerWarp = kRows / kWarps;   // score phase: warp w owns rows w + 4i
constexpr int kColGroups = kThreads / kRows;   // PV phase: 8 threads share a row
constexpr float kNegInf = -1e9f;               // the TPU kernel's finite mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

// p as P.V reads it from fp pools of KV_T: rounded once to bf16 / fp16
// (the TPU kernel's p.astype(v.dtype)), unchanged for fp32.
template <typename KV_T>
__device__ __forceinline__ float round_p(float p) { return p; }
template <>
__device__ __forceinline__ float round_p<__half>(float p) {
  return __half2float(__float2half_rn(p));
}
template <>
__device__ __forceinline__ float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// One 16-byte load of 16 / sizeof(T) consecutive elements, widened to fp32.
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ src, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) dst[i] = to_float(e[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr int smem_floats(int dh) {
  return kRows * dh            // q tile
         + kKeys * (dh + 1)    // K tile, rows padded by one so lanes hit distinct banks
         + kKeys * dh          // V tile
         + kRows * (kKeys + 1) // p tile
         + 2 * kRows;          // per-row alpha and final l
}

// Grid (q tiles, KV, S). Rows of a (sequence, kv head) are ordered
// (rep, Q) as in the TPU kernel: global row g is query head h * rep + g / Q
// at token g % Q.
template <typename T, typename KV_T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_mha_kernel(const T* __restrict__ q, const KV_T* __restrict__ k_pool,
                 const KV_T* __restrict__ v_pool, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const int* __restrict__ block_tables,
                 const int* __restrict__ seen, const int* __restrict__ q_len,
                 T* __restrict__ out, int Q, int H, int KV, int NB, int bs, int MB,
                 float scale, int window) {
  constexpr bool kQuant = std::is_same<KV_T, int8_t>::value;
  constexpr int kVec = 16 / sizeof(KV_T);
  constexpr int kChunks = DH / kVec;           // 16-byte chunks per key row
  constexpr int kCols = DH / kColGroups;       // accumulator columns per thread
  constexpr int kKStride = DH + 1;

  extern __shared__ float smem[];
  float* sq = smem;                            // [kRows][DH]
  float* sk = sq + kRows * DH;                 // [kKeys][DH + 1]
  float* sv = sk + kKeys * kKStride;           // [kKeys][DH]
  float* sp = sv + kKeys * DH;                 // [kRows][kKeys + 1]
  float* salpha = sp + kRows * (kKeys + 1);    // [kRows]
  float* sl = salpha + kRows;                  // [kRows]

  const int tile = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rep = H / KV;
  const int n_rows = rep * Q;
  const int seen_s = seen[s];
  const int qlen_s = q_len[s];
  const int row0 = tile * kRows;

  // the tile's live query tokens bound the keys it can see
  int qi_min = INT_MAX, qi_max = -1;
  for (int r = 0; r < kRows; ++r) {
    const int g = row0 + r;
    if (g < n_rows && g % Q < qlen_s) {
      qi_min = min(qi_min, g % Q);
      qi_max = max(qi_max, g % Q);
    }
  }
  const int key_end = qi_max >= 0 ? seen_s + qi_max + 1 : 0;   // exclusive
  const int key_begin = (window > 0 && qi_max >= 0) ? max(0, seen_s + qi_min - window + 1) : 0;

  for (int i = tid; i < kRows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, g = row0 + r;
    float x = 0.f;
    if (g < n_rows && g % Q < qlen_s) {
      const int head = h * rep + g / Q;
      x = to_float(q[((static_cast<size_t>(s) * Q + g % Q) * H + head) * DH + d]);
    }
    sq[i] = x;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int pr = tid / kColGroups;   // PV row of this thread
  const int pc = tid % kColGroups;   // its columns: pc + kColGroups * c
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  __syncthreads();

  const int jb_first = key_begin / bs;
  const int jb_last = key_end > 0 ? min((key_end - 1) / bs, MB - 1) : -1;
  for (int jb = jb_first; jb <= jb_last; ++jb) {
    const int page = min(max(block_tables[static_cast<size_t>(s) * MB + jb], 0), NB - 1);
    const size_t page_row = (static_cast<size_t>(page) * KV + h) * bs;   // first token row
    for (int t0 = 0; t0 < bs; t0 += kKeys) {
      const int kpos0 = jb * bs + t0;
      if (kpos0 >= key_end) break;
      if (kpos0 + kKeys <= key_begin) continue;
      const int nk = min(kKeys, bs - t0);

      for (int i = tid; i < nk * kChunks; i += kThreads) {
        const int j = i / kChunks, d = (i % kChunks) * kVec;
        const size_t src = (page_row + t0 + j) * DH + d;
        float buf[kVec];
        load16(k_pool + src, buf);
#pragma unroll
        for (int e = 0; e < kVec; ++e) sk[j * kKStride + d + e] = buf[e];
        load16(v_pool + src, buf);
#pragma unroll
        for (int e = 0; e < kVec; ++e) sv[j * DH + d + e] = buf[e];
      }
      __syncthreads();

      // scores: lane = key, warp w = rows w, w + 4, w + 8, w + 12
      float sc[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
      const float* krow = sk + lane * kKStride;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float kd = krow[d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) sc[i] += sq[(warp + kWarps * i) * DH + d] * kd;
      }
      const bool in_page = lane < nk;
      const int kpos = kpos0 + lane;
      float ks = 1.f, vs = 1.f;
      if (kQuant && in_page) {
        ks = k_scale[page_row + t0 + lane];
        vs = v_scale[page_row + t0 + lane];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i, g = row0 + r;
        const bool live = g < n_rows && g % Q < qlen_s;
        const int qpos = seen_s + g % Q;
        float x = sc[i] * scale;
        if (kQuant) x *= ks;
        const bool visible = in_page && live && kpos <= qpos &&
                             (window <= 0 || kpos > qpos - window);
        x = visible ? x : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(x));
        const float alpha = expf(m[i] - m_new);
        const float p = in_page ? expf(x - m_new) : 0.f;
        l[i] = alpha * l[i] + warp_sum(p);
        m[i] = m_new;
        sp[r * (kKeys + 1) + lane] = kQuant ? p * vs : round_p<KV_T>(p);
        if (lane == 0) salpha[r] = alpha;
      }
      __syncthreads();

      // PV: thread owns row pr, columns pc + 8c
      const float alpha = salpha[pr];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
      const float* prow = sp + pr * (kKeys + 1);
      for (int j = 0; j < nk; ++j) {
        const float pj = prow[j];
        const float* vrow = sv + j * DH + pc;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] += pj * vrow[kColGroups * c];
      }
      __syncthreads();   // the next tile overwrites sk, sv and sp
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sl[warp + kWarps * i] = l[i];
  }
  __syncthreads();

  const int g = row0 + pr;
  if (g < n_rows) {
    const int qi = g % Q, head = h * rep + g / Q;
    const bool live = qi < qlen_s;
    const float l_safe = sl[pr] == 0.f ? 1.f : sl[pr];
    T* dst = out + ((static_cast<size_t>(s) * Q + qi) * H + head) * DH + pc;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(dst + kColGroups * c, live ? acc[c] / l_safe : 0.f);
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16 with fp pools on the tensor cores: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int kTcStages = 3;            // K / V ring depth
constexpr int kTcThreads = 128 + 32;    // one consumer warpgroup, one producer warp
constexpr int kTile = 64;               // keys per tile, query rows per item
constexpr uint32_t kColBlock = kTile * 128;   // one [64 rows][64 columns] swizzled block

// The tensor-core route's arguments (ds_paged_mha's, one struct).
struct PagedParams {
  const void* q;               // [S, Q, H, Dh]
  const int* block_tables;     // [S, MB]
  const int* seen;             // [S]
  const int* q_len;            // [S]
  void* out;                   // [S, Q, H, Dh]
  float* o_ws;                 // splits > 1: [splits, S, KV, rep * Q, Dh] fp32
  float* ml_ws;                // splits > 1: [splits, S, KV, rep * Q, 2] fp32 (m, l)
  int S, Q, H, KV, NB, bs, MB, dh, splits;
  float scale;
  int window;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = hopper::pack2<T>(x, y);
}

// Grid (row tiles x splits, KV, S): blockIdx.x = row tile * splits + split.
// Warps 0-3 the consumer warpgroup, warp 4 the producer (lane 0). Score
// element i of a consumer thread is tile row 16 warp + lane / 4 + 8 (i % 4 /
// 2), key k0 + 8 (i / 4) + 2 (lane % 4) + i % 2; output element (c, i) the
// same row, column 64 c + 8 (i / 4) + 2 (lane % 4) + i % 2.
template <typename T, int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
    paged_mha_wgmma(const __grid_constant__ PagedParams p, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv) {
  constexpr int NDC = DH / 64;
  constexpr uint32_t kKBytes = NDC * kColBlock;
  constexpr uint32_t kStageBytes = 2 * kKBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                               ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kTcStages * kStageBytes);
  uint64_t* empty = full + kTcStages;

  const int h = blockIdx.y, s = blockIdx.z;
  const int rt = blockIdx.x / p.splits, sp = blockIdx.x % p.splits;
  const int rep = p.H / p.KV, n_rows = rep * p.Q;
  const int row0 = rt * kTile, row_end = min(row0 + kTile, n_rows);
  const int seen_s = p.seen[s], qlen_s = p.q_len[s];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* out = static_cast<T*>(p.out);

  // the tile's live query tokens bound the keys it can see
  int qi_min = INT_MAX, qi_max = -1;
  for (int g = row0; g < row_end; ++g) {
    const int qi = g % p.Q;
    if (qi < qlen_s) {
      qi_min = min(qi_min, qi);
      qi_max = max(qi_max, qi);
    }
  }
  if (qi_max < 0) {   // no live row: zeros (the combine writes them when split)
    if (p.splits == 1)
      for (int e = threadIdx.x; e < (row_end - row0) * DH; e += blockDim.x) {
        const int g = row0 + e / DH;
        store(out + ((static_cast<size_t>(s) * p.Q + g % p.Q) * p.H + h * rep + g / p.Q) * DH +
                  e % DH,
              0.f);
      }
    return;
  }
  const int key_end = seen_s + qi_max + 1;   // exclusive
  const int key_begin = p.window > 0 ? max(0, seen_s + qi_min - p.window + 1) : 0;
  const int t_first = key_begin / kTile, t_last = (key_end + kTile - 1) / kTile;
  // split sp owns the key tiles [sp * per, (sp + 1) * per) of the block
  // table's width, the last split all that follow: boundaries fixed by the
  // call's shape, so that a row's result does not depend on the other live
  // rows of its tile (a decode row and the same position in a verify chunk
  // combine the same splits, bit for bit); the item's rows clip them
  const int per = ((p.MB * p.bs + kTile - 1) / kTile + p.splits - 1) / p.splits;
  const int t_begin = max(t_first, sp * per);
  const int t_end = sp == p.splits - 1 ? t_last : min(t_last, (sp + 1) * per);
  const size_t ws_row0 = ((static_cast<size_t>(sp) * p.S + s) * p.KV + h) * n_rows;

  if (t_begin >= t_end) {   // an empty split: m = -inf, l = 0, never read further
    for (int g = row0 + threadIdx.x; g < row_end; g += blockDim.x) {
      p.ml_ws[(ws_row0 + g) * 2] = -INFINITY;
      p.ml_ws[(ws_row0 + g) * 2 + 1] = 0.f;
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int st = 0; st < kTcStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {   // the producer
    if (lane != 0) return;
    const int* bt = p.block_tables + static_cast<size_t>(s) * p.MB;
    const int box_rows = min(p.bs, kTile);
    for (int jt = t_begin, i = 0; jt < t_end; ++jt, ++i) {
      const int st = i % kTcStages;
      if (i >= kTcStages) hopper::mbar_wait(&empty[st], (i / kTcStages - 1) & 1);
      uint8_t* kt = stages + st * kStageBytes;
      hopper::mbar_arrive_expect_tx(&full[st], kStageBytes);
      for (int r = 0; r < kTile; r += box_rows) {   // the pages of the key tile
        const int key = jt * kTile + r, jb = key / p.bs;
        const int page = jb < p.MB ? min(max(__ldg(bt + jb), 0), p.NB - 1) : 0;
        const int row = (page * p.KV + h) * p.bs + key % p.bs;
#pragma unroll
        for (int c = 0; c < NDC; ++c) {
          hopper::tma_load_2d(kt + c * kColBlock + r * 128, &tk, &full[st], 64 * c, row);
          hopper::tma_load_2d(kt + kKBytes + c * kColBlock + r * 128, &tv, &full[st], 64 * c, row);
        }
      }
    }
    return;
  }

  // q's rows as wgmma A fragments: rows r[e] = 16 warp + lane / 4 + 8 e of
  // the tile, columns 16 kk + 2 (lane % 4) (+ 8): zeros for rows that are
  // not live
  const T* q = static_cast<const T*>(p.q);
  int qi[2];
  bool live[2];
  const T* qrow[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int g = row0 + 16 * warp + lane / 4 + 8 * e;
    qi[e] = g % p.Q;
    live[e] = g < row_end && qi[e] < qlen_s;
    qrow[e] = q + ((static_cast<size_t>(s) * p.Q + qi[e]) * p.H + h * rep + g / p.Q) * DH;
  }
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = u % 2, col = 16 * kk + 2 * (lane % 4) + 8 * (u / 2);
      qa[kk][u] = live[e] ? *reinterpret_cast<const uint32_t*>(qrow[e] + col) : 0u;
    }

  float o[NDC][32];
#pragma unroll
  for (int c = 0; c < NDC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int qpos[2] = {seen_s + qi[0], seen_s + qi[1]};

  for (int jt = t_begin, it = 0; jt < t_end; ++jt, ++it) {
    const int st = it % kTcStages;
    const uint32_t k_tile = hopper::smem_u32(stages) + st * kStageBytes;
    const uint32_t v_tile = k_tile + kKBytes;
    hopper::mbar_wait(&full[st], (it / kTcStages) & 1);

    float x[32];
    hopper::fence_regs(x);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hopper::wgmma_rs<T>(x, qa[kk],
                          hopper::desc_sw128(k_tile + (kk / 4) * kColBlock + (kk % 4) * 32),
                          kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(x);

    // s = q.k * scale where the key is visible to the row, else NEG_INF
    const int k0 = jt * kTile;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i % 4) / 2;
      const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      const bool visible = key <= qpos[e] && (p.window <= 0 || key > qpos[e] - p.window);
      x[i] = visible ? x[i] * p.scale : kNegInf;
      mx[e] = fmaxf(mx[e], x[i]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float m_new = fmaxf(m[e], quad_max(mx[e]));
      alpha[e] = expf(m[e] - m_new);
      m[e] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      x[i] = expf(x[i] - m[(i % 4) / 2]);
      sum[(i % 4) / 2] += x[i];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) l[e] = alpha[e] * l[e] + quad_sum(sum[e]);
#pragma unroll
    for (int c = 0; c < NDC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i % 4) / 2];

    uint32_t pa[4][4];   // p.astype(v.dtype), as the register A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int jj = 8 * kk;
      pa[kk][0] = hopper::pack2<T>(x[jj + 0], x[jj + 1]);
      pa[kk][1] = hopper::pack2<T>(x[jj + 2], x[jj + 3]);
      pa[kk][2] = hopper::pack2<T>(x[jj + 4], x[jj + 5]);
      pa[kk][3] = hopper::pack2<T>(x[jj + 6], x[jj + 7]);
    }
#pragma unroll
    for (int c = 0; c < NDC; ++c) hopper::fence_regs(o[c]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NDC; ++c)
        hopper::wgmma_rs_mn<T>(o[c], pa[kk],
                               hopper::desc_sw128(v_tile + c * kColBlock + kk * 16 * 128));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NDC; ++c) hopper::fence_regs(o[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(pa[kk]);
    hopper::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int g = row0 + 16 * warp + lane / 4 + 8 * e;
    if (g >= row_end) continue;
    if (p.splits == 1) {
      T* dst = out + ((static_cast<size_t>(s) * p.Q + qi[e]) * p.H + h * rep + g / p.Q) * DH;
      const float l_safe = l[e] == 0.f ? 1.f : l[e];
#pragma unroll
      for (int c = 0; c < NDC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          store2(dst + 64 * c + 8 * j + 2 * (lane % 4),
                 live[e] ? o[c][4 * j + 2 * e] / l_safe : 0.f,
                 live[e] ? o[c][4 * j + 2 * e + 1] / l_safe : 0.f);
    } else if (live[e]) {
      float* dst = p.o_ws + (ws_row0 + g) * DH;
#pragma unroll
      for (int c = 0; c < NDC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(dst + 64 * c + 8 * j + 2 * (lane % 4)) =
              make_float2(o[c][4 * j + 2 * e], o[c][4 * j + 2 * e + 1]);
      if (lane % 4 == 0) {
        p.ml_ws[(ws_row0 + g) * 2] = m[e];
        p.ml_ws[(ws_row0 + g) * 2 + 1] = l[e];
      }
    }
  }
}

// The splits of each output row merged in split order: out = sum_s w_s o_s /
// sum_s w_s l_s with w_s = exp(m_s - max m); a split that saw no key (l = 0)
// is skipped; rows qi >= q_len are 0. One block of Dh threads per row of
// out, blockIdx.x = (s * Q + qi) * H + head.
template <typename T, int DH>
__global__ void __launch_bounds__(DH) paged_mha_combine(const __grid_constant__ PagedParams p) {
  const int head = blockIdx.x % p.H;
  const int qi = (blockIdx.x / p.H) % p.Q;
  const int s = blockIdx.x / (p.H * p.Q);
  const int rep = p.H / p.KV, h = head / rep;
  const int g = (head - h * rep) * p.Q + qi, n_rows = rep * p.Q;
  T* dst = static_cast<T*>(p.out) + static_cast<size_t>(blockIdx.x) * DH;
  if (qi >= p.q_len[s]) {
    store(dst + threadIdx.x, 0.f);
    return;
  }
  const size_t stride = static_cast<size_t>(p.S) * p.KV * n_rows;   // rows per split
  const size_t row = (static_cast<size_t>(s) * p.KV + h) * n_rows + g;
  float mmax = -INFINITY;
  for (int sp = 0; sp < p.splits; ++sp)
    if (p.ml_ws[(sp * stride + row) * 2 + 1] > 0.f)
      mmax = fmaxf(mmax, p.ml_ws[(sp * stride + row) * 2]);
  float num = 0.f, den = 0.f;
  for (int sp = 0; sp < p.splits; ++sp) {
    const float ls = p.ml_ws[(sp * stride + row) * 2 + 1];
    if (!(ls > 0.f)) continue;
    const float w = expf(p.ml_ws[(sp * stride + row) * 2] - mmax);
    num += w * p.o_ws[(sp * stride + row) * DH + threadIdx.x];
    den += w * ls;
  }
  store(dst + threadIdx.x, den > 0.f ? num / den : 0.f);
}

// The tensor-core route: tensor maps of the pools seen as [NB * KV * bs, Dh]
// (boxes of min(bs, 64) rows x 64 columns; remembered, as a layer's pools
// stay at one address), the kernel over (row tiles x
// splits, KV, S), then with splits > 1 the combine over every output row.
template <typename T, int DH>
cudaError_t launch_wgmma(const PagedParams& p, const void* k_pool, const void* v_pool,
                         cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  using u64 = cuuint64_t;
  const u64 dims[2] = {static_cast<u64>(DH), static_cast<u64>(p.NB) * p.KV * p.bs};
  const u64 strides[1] = {static_cast<u64>(DH) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(p.bs < kTile ? p.bs : kTile)};
  CUtensorMap tk, tv;
  constexpr CUtensorMapDataType type =
      f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!hopper::make_map_of_cached(&tk, k_pool, type, 2, dims, strides, box) ||
      !hopper::make_map_of_cached(&tv, v_pool, type, 2, dims, strides, box))
    return cudaErrorInvalidValue;
  auto kernel = paged_mha_wgmma<T, DH>;
  constexpr int smem = 1024 + kTcStages * 2 * (DH / 64) * kColBlock + 16 * kTcStages;
  cudaError_t e = hopper::allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  const int n_rt = ((p.H / p.KV) * p.Q + kTile - 1) / kTile;
  kernel<<<dim3(n_rt * p.splits, p.KV, p.S), kTcThreads, smem, stream>>>(p, tk, tv);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  paged_mha_combine<T, DH><<<p.S * p.Q * p.H, DH, 0, stream>>>(p);
  return cudaGetLastError();
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* k_scale;
  const void* v_scale;
  const void* block_tables;
  const void* seen;
  const void* q_len;
  void* out;
  int S, Q, H, KV, NB, bs, MB;
  float scale;
  int window;
};

template <typename T, typename KV_T, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int n_tiles = ((a.H / a.KV) * a.Q + kRows - 1) / kRows;
  const size_t smem = smem_floats(DH) * sizeof(float);
  auto kernel = paged_mha_kernel<T, KV_T, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_tiles, a.KV, a.S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV_T*>(a.k_pool),
      static_cast<const KV_T*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.seen), static_cast<const int*>(a.q_len),
      static_cast<T*>(a.out), a.Q, a.H, a.KV, a.NB, a.bs, a.MB, a.scale, a.window);
  return cudaGetLastError();
}

template <typename T, typename KV_T>
cudaError_t dispatch_dh(const Args& a, int dh, cudaStream_t stream) {
  switch (dh) {
#define DS_DH_CASE(D) \
  case D:             \
    return launch<T, KV_T, D>(a, stream);
    DS_DH_CASE(16) DS_DH_CASE(32) DS_DH_CASE(48) DS_DH_CASE(64)
    DS_DH_CASE(80) DS_DH_CASE(96) DS_DH_CASE(112) DS_DH_CASE(128)
    DS_DH_CASE(144) DS_DH_CASE(160) DS_DH_CASE(176) DS_DH_CASE(192)
    DS_DH_CASE(208) DS_DH_CASE(224) DS_DH_CASE(240) DS_DH_CASE(256)
#undef DS_DH_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_pool(const Args& a, int dh, int quantized, cudaStream_t stream) {
  return quantized ? dispatch_dh<T, int8_t>(a, dh, stream) : dispatch_dh<T, T>(a, dh, stream);
}

// The kernels, in the order of the launch tally (ds_paged_kernel_launches).
enum Kernel { kSimt, kWgmma, kNumKernels };
long long g_launches[kNumKernels] = {};

// The kernel for dtype code `dtype` (0 fp32, 1 fp16, 2 bf16), int8 pools or
// not, head width dh and block size bs; -1 for what neither takes. bf16 /
// fp16 q with fp pools at head width 64 or 128 and a block size that is a
// multiple of 16 dividing 64, or a multiple of 64, go to the tensor cores
// (a key tile is 64 keys of whole boxes; the 64-column blocks of the
// swizzled tiles hold the head), everything else to the SIMT kernel (see
// the header).
int paged_route(int dtype, int quantized, int dh, int bs) {
  if (dtype < 0 || dtype > 2 || dh < 16 || dh > 256 || dh % 16 || bs < 1) return -1;
  const bool tiles = bs % 16 == 0 && (64 % bs == 0 || bs % 64 == 0);
  return dtype != 0 && !quantized && (dh == 64 || dh == 128) && tiles ? kWgmma : kSimt;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, out and fp pools).
// quantized: pools are int8 and k_scale / v_scale point at fp32 scale pools.
// window <= 0 means no sliding window. `splits` key splits (the tensor-core
// route only; 1 elsewhere) need o_ws [splits, S, KV, H / KV * Q, dh] and
// ml_ws [splits, S, KV, H / KV * Q, 2] fp32. Launches the route's kernel
// (paged_route) and returns a cudaError_t code.
extern "C" int ds_paged_mha(const void* q, const void* k_pool, const void* v_pool,
                            const void* k_scale, const void* v_scale,
                            const void* block_tables, const void* seen, const void* q_len,
                            void* out, void* o_ws, void* ml_ws, int S, int Q, int H, int KV,
                            int NB, int bs, int MB, int dh, int dtype, int quantized, float scale,
                            int window, int splits, void* stream) {
  const int k = paged_route(dtype, quantized, dh, bs);
  if (k < 0 || splits < 1 || (splits > 1 && (k != kWgmma || o_ws == nullptr || ml_ws == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (k == kWgmma) {
    const PagedParams p{q, static_cast<const int*>(block_tables), static_cast<const int*>(seen),
                        static_cast<const int*>(q_len), out, static_cast<float*>(o_ws),
                        static_cast<float*>(ml_ws), S, Q, H, KV, NB, bs, MB, dh, splits, scale,
                        window};
    if (dtype == 1)
      e = dh == 64 ? launch_wgmma<__half, 64>(p, k_pool, v_pool, st)
                   : launch_wgmma<__half, 128>(p, k_pool, v_pool, st);
    else
      e = dh == 64 ? launch_wgmma<__nv_bfloat16, 64>(p, k_pool, v_pool, st)
                   : launch_wgmma<__nv_bfloat16, 128>(p, k_pool, v_pool, st);
  } else {
    const Args a{q, k_pool, v_pool, k_scale, v_scale, block_tables, seen, q_len, out,
                 S, Q, H, KV, NB, bs, MB, scale, window};
    switch (dtype) {
      case 0:
        e = dispatch_pool<float>(a, dh, quantized, st);
        break;
      case 1:
        e = dispatch_pool<__half>(a, dh, quantized, st);
        break;
      default:
        e = dispatch_pool<__nv_bfloat16>(a, dh, quantized, st);
    }
  }
  if (e == cudaSuccess) ++g_launches[k];
  return static_cast<int>(e);
}

// The kernel (0 SIMT, 1 wgmma: the launch tally's order) for dtype code
// `dtype`, int8 pools or not, head width and block size; -1 where none
// takes them.
extern "C" int ds_paged_route(int dtype, int quantized, int dh, int bs) {
  return paged_route(dtype, quantized, dh, bs);
}

// Launches so far of one kernel, in the order above; -1 past the end.
extern "C" long long ds_paged_kernel_launches(int kernel) {
  return kernel >= 0 && kernel < kNumKernels ? g_launches[kernel] : -1;
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
