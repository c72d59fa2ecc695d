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
// What the design does about it. The TPU grid (seqs, kv_heads, max_blocks)
// runs in order on one core and carries the softmax state across grid steps
// in VMEM; here one thread block owns (a tile of 16 query rows, one kv head,
// one sequence) and loops over that sequence's live pages itself:
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
//   - the output is written straight into q's [S, Q, H, Dh] layout, with
//     none of the TPU wrapper's transposes.
// This is the simple, correct first kernel: mma.sync / wgmma tiles, TMA and
// split-K over long sequences are later work.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

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
        sp[r * (kKeys + 1) + lane] = kQuant ? p * vs : p;
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

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, out and fp pools).
// quantized: pools are int8 and k_scale / v_scale point at fp32 scale pools.
// window <= 0 means no sliding window. Returns a cudaError_t code.
extern "C" int ds_paged_mha(const void* q, const void* k_pool, const void* v_pool,
                            const void* k_scale, const void* v_scale,
                            const void* block_tables, const void* seen, const void* q_len,
                            void* out, int S, int Q, int H, int KV, int NB, int bs, int MB,
                            int dh, int dtype, int quantized, float scale, int window,
                            void* stream) {
  const Args a{q, k_pool, v_pool, k_scale, v_scale, block_tables, seen, q_len, out,
               S, Q, H, KV, NB, bs, MB, scale, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_pool<float>(a, dh, quantized, st);
    case 1:
      return dispatch_pool<__half>(a, dh, quantized, st);
    case 2:
      return dispatch_pool<__nv_bfloat16>(a, dh, quantized, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
