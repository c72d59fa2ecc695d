// Groupwise quantize and dequantize-reduce, the two halves of the ZeRO++
// quantized gradient exchange (qgZ), for Hopper (sm_90a). Built by
// deepspeed_tpu_torch/ops/cuda_build.py with nvcc into a shared library with
// a plain C interface, called through ctypes by
// deepspeed_tpu_torch/ops/quant_collective.py (block_quantize,
// block_dequantize_reduce, block_dequantize).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/quant_collective.py:
//   quantize  `_quantize_rows_local` (pl.pallas_call at :273; public entry
//             `block_quantize`): payload rows x [R, M], fp32 or bf16, cut into
//             G = ceil(M / gs) groups of gs elements per row (the tail past M
//             is quantized as zeros, as `_prep_rows` pads). Per group:
//               scale = amax > 0 ? amax / qmax : 1     (qmax 127 or 7)
//               q     = clip(round_half_even(x / scale), -qmax, qmax)
//             8-bit: int8, one byte per element. 4-bit: uint8, half-split
//             packed: byte j of a group holds element j in its low nibble and
//             element j + gs/2 in its high nibble. scale fp32 [R, G].
//   dequantize-reduce `_deq_reduce_local` (pl.pallas_call at :344; public
//             entries `block_dequantize_reduce`, and `block_dequantize` with
//             one peer): wire [P, N, gsw] + scales [P, N] -> fp32 [N, gs],
//             acc = 0; acc += q[p] * scale[p] for p = 0 .. P-1 in order.
//
// Bit-exactness with the plain PyTorch versions (and the JAX package's
// wire format) comes from IEEE arithmetic in the order those versions use:
// __fdiv_rn for both divisions (no reciprocal multiply), __float2int_rn
// (round half to even, as torch.round and jnp.round), and __fmul_rn /
// __fadd_rn in the reduction so that no multiply-add is contracted into an
// FMA. The build passes no --use_fast_math.
//
// What bounds it on the H100: bytes. Quantize reads 4 (fp32) or 2 (bf16)
// bytes per element and writes 1 or 0.5 plus 4 bytes of scale per group, with
// a few operations per element; dequantize-reduce reads P wire rows and
// writes 4 bytes per element. At 3.35 TB/s a gate_proj chunk exchange of
// Llama-2-7B at W=4 (4 x 11,272,192 fp32 elements) bounds quantize at about
// 0.06 ms and dequantize-reduce at about 0.02 ms.
//
// What the design does about it: two routes per operation, which the
// source declares (quantize_route, dequant_route; ds_quant_route) and
// counts (ds_quant_kernel_launches).
//
//   quantize_warp, the main path's quantize: one warp per group, the group
//     held in registers. Each lane issues all its 16-byte loads of the
//     group at once (64 fp32 values at gs 2048: 8 KB in flight a warp,
//     some 25 warps an SM), reduces the amax by warp shuffles alone (the
//     unsigned maximum of |x|'s bits, which orders non-negative floats and
//     puts a NaN above all: no block barrier, no second read), then
//     quantizes, packs and stores from the same registers. Takes groups of
//     1 to 8 KB in whole KB, rows whose byte length is a multiple of 16 and
//     16-byte aligned data. A ring of bulk copies feeding 4 consumer warps
//     a block (the design of dequant_reduce_stream) measured 5-7% slower
//     here: its consumers were too few for the per-element division.
//   dequant_reduce_stream, the main path's dequantize-reduce: a persistent
//     grid of blocks, one producer warp and kConsumers consumer warps each,
//     streams the output groups through a ring of kStages shared-memory
//     stages. A stage holds one output group's P wire rows, filled by 1-D
//     bulk copies (cp.async.bulk, completing on the stage's mbarrier), and
//     its P scales (cp.async, reported to the same barrier). P is a
//     template argument, so a lane loads all P words before its first add;
//     it stores 16 bytes of fp32 output a step. Takes gs a multiple of 256
//     whose P wire rows fit one 16 KB stage, P <= 8, output rows whose byte
//     length is a multiple of 16 and 16-byte aligned data.
//   quantize_block, dequant_reduce_block: every other shape (odd group
//     sizes, offset views, odd row lengths, larger groups, P > 8). One block
//     of 256 threads owns one group: it reduces the group's amax (warp
//     shuffles, then one shared-memory step), then quantizes, rereading
//     the group from L1/L2; loads are 16 bytes a thread where the row
//     length and group size allow it, else one element; the reduction gives
//     each thread 4 wire bytes of a group and walks the peers in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// max that keeps a NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_max[lane] : 0.f;
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) warp_max[0] = v;
  }
  __syncthreads();
  return warp_max[0];
}

// VEC consecutive elements of `row` from column `col` (a multiple of VEC),
// zero past M. VEC > 1 is one 16-byte load (the host checked alignment).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ row, long long col, long long M,
                                         float (&v)[VEC]) {
  if constexpr (VEC > 1) {
    if (col + VEC <= M) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + col);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = (col + i < M) ? to_f32(row[col + i]) : 0.f;
}

template <int VEC>
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint8_t (&b)[VEC]) {
  if constexpr (VEC == 4) {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) w |= static_cast<uint32_t>(b[i]) << (8 * i);
    *reinterpret_cast<uint32_t*>(dst) = w;
  } else if constexpr (VEC == 8) {
    uint2 w = make_uint2(0u, 0u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w.x |= static_cast<uint32_t>(b[i]) << (8 * i);
      w.y |= static_cast<uint32_t>(b[i + 4]) << (8 * i);
    }
    *reinterpret_cast<uint2*>(dst) = w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = b[i];
  }
}

__device__ __forceinline__ int quantize_one(float v, float s, int qmax) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return q < -qmax ? -qmax : (q > qmax ? qmax : q);
}

// ---------------------------------------------------------------------------
// the block route
// ---------------------------------------------------------------------------

// The block route of quantize. One block per group-row b = r * G + g:
// elements [g * gs, (g + 1) * gs) of row r of x [R, M]. Writes
// q[b * gsw ...] and scale[b].
template <typename T, int VEC, int BITS>
__global__ void __launch_bounds__(kThreads)
quantize_block(const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ scale,
               long long M, int G, int gs) {
  const long long b = blockIdx.x;
  const T* row = x + (b / G) * M;
  const long long base = (b % G) * static_cast<long long>(gs);
  constexpr int qmax = BITS == 8 ? 127 : 7;

  float amax = 0.f;
  for (int e = threadIdx.x * VEC; e < gs; e += kThreads * VEC) {
    float v[VEC];
    load_vec<T, VEC>(row, base + e, M, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) amax = nan_max(amax, fabsf(v[i]));
  }
  amax = block_max(amax);
  const float s = amax > 0.f ? __fdiv_rn(amax, static_cast<float>(qmax)) : 1.f;
  if (threadIdx.x == 0) scale[b] = s;

  if constexpr (BITS == 8) {
    uint8_t* out = q + b * gs;
    for (int e = threadIdx.x * VEC; e < gs; e += kThreads * VEC) {
      float v[VEC];
      load_vec<T, VEC>(row, base + e, M, v);
      uint8_t packed[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        packed[i] = static_cast<uint8_t>(static_cast<int8_t>(quantize_one(v[i], s, qmax)));
      store_bytes<VEC>(out + e, packed);
    }
  } else {
    const int h = gs / 2;
    uint8_t* out = q + b * h;
    for (int e = threadIdx.x * VEC; e < h; e += kThreads * VEC) {
      float lo[VEC], hi[VEC];
      load_vec<T, VEC>(row, base + e, M, lo);
      load_vec<T, VEC>(row, base + h + e, M, hi);
      uint8_t packed[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        packed[i] = static_cast<uint8_t>((quantize_one(lo[i], s, qmax) & 0xF) |
                                         ((quantize_one(hi[i], s, qmax) & 0xF) << 4));
      store_bytes<VEC>(out + e, packed);
    }
  }
}

__device__ __forceinline__ float nibble(uint32_t v) {
  const int n = static_cast<int>(v & 0xF);
  return static_cast<float>(n > 7 ? n - 16 : n);
}

// Store `n` consecutive accumulators at out_row[col ...], masked at out_cols;
// one 16-byte store when `vec` (the host checked alignment) and in bounds.
template <int N>
__device__ __forceinline__ void store_floats(float* out_row, long long col, long long out_cols,
                                             const float* acc, bool vec) {
  if constexpr (N == 4) {
    if (vec && col + 4 <= out_cols) {
      *reinterpret_cast<float4*>(out_row + col) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (col + i < out_cols) out_row[col + i] = acc[i];
}

// The block route of dequantize-reduce. One block per group-row
// b = r * G + g of the output [R, out_cols]: sums the P peers' dequantized
// groups b (wire q [P, R * G, gsw], scales [P, R * G]) in peer order. WORD
// bytes of wire per thread step: 4 when the wire width allows aligned
// 4-byte loads, else 1.
template <int BITS, int WORD>
__global__ void __launch_bounds__(kThreads)
dequant_reduce_block(const uint8_t* __restrict__ q, const float* __restrict__ scale,
                     float* __restrict__ out, int P, long long N, int G, int gs,
                     long long out_cols, bool vec_store) {
  const long long b = blockIdx.x;
  float* out_row = out + (b / G) * out_cols;
  const long long col0 = (b % G) * static_cast<long long>(gs);
  const int h = gs / 2;
  const int gsw = BITS == 8 ? gs : h;
  constexpr int NV = BITS == 8 ? WORD : 2 * WORD;
  for (int u = threadIdx.x * WORD; u < gsw; u += kThreads * WORD) {
    float acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.f;
    for (int p = 0; p < P; ++p) {
      const long long pb = p * N + b;
      const float s = scale[pb];
      const uint8_t* src = q + pb * gsw + u;
      const uint32_t w = WORD == 4 ? *reinterpret_cast<const uint32_t*>(src) : *src;
#pragma unroll
      for (int k = 0; k < WORD; ++k) {
        const uint32_t byte = (w >> (8 * k)) & 0xFFu;
        if constexpr (BITS == 8) {
          const float v = static_cast<float>(static_cast<int8_t>(byte));
          acc[k] = __fadd_rn(acc[k], __fmul_rn(v, s));
        } else {
          acc[k] = __fadd_rn(acc[k], __fmul_rn(nibble(byte), s));
          acc[WORD + k] = __fadd_rn(acc[WORD + k], __fmul_rn(nibble(byte >> 4), s));
        }
      }
    }
    store_floats<WORD>(out_row, col0 + u, out_cols, acc, vec_store);
    if constexpr (BITS == 4) store_floats<WORD>(out_row, col0 + h + u, out_cols, acc + WORD, vec_store);
  }
}

// ---------------------------------------------------------------------------
// the warp route of quantize
// ---------------------------------------------------------------------------

constexpr int kWarpChunks = 16;       // 16-byte chunks a lane holds: groups up to 8 KB

__device__ __forceinline__ void unpack16(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack16(const uint4& raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);        // bf16 -> fp32 is exact
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// The warp route of quantize. Warp w of block i owns the group-row
// b = 8 i + w (b = r * G + g) of x [R, M] and holds it in registers: lane
// l loads its 16-byte chunks (VEC elements each) l, l + 32, ... all at once
// (for 4 bits, the low-half chunks into raw[0 ..] and their high-half
// partners, gs / 2 elements on, into raw[kWarpChunks / 2 ..], so that a lane
// holds both nibbles of its bytes), reduces the amax by warp shuffles alone
// (the unsigned maximum of |x|'s bits, which orders non-negative floats and
// puts a NaN above all), then quantizes, packs and stores. Chunks past M
// (a row's last group) read as zeros. A group is `ch` chunks a lane, at
// most kWarpChunks (8 KB), and ch is even.
template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
quantize_warp(const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ scale,
              long long M, int G, int gs, long long n_groups) {
  constexpr int VEC = 16 / sizeof(T), HALF = kWarpChunks / 2;
  constexpr int qmax = BITS == 8 ? 127 : 7;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = static_cast<long long>(blockIdx.x) * (kThreads / 32) + warp;
  if (b >= n_groups) return;
  const long long col = (b % G) * gs;
  const int valid = static_cast<int>((M - col < gs ? M - col : gs) / VEC);   // chunks in range
  const int ch = gs / VEC / 32;
  const int hc = gs / 2 / VEC;                                               // chunks a half
  const uint4* src = reinterpret_cast<const uint4*>(x + (b / G) * M + col);
  // chunk of raw[i] (when held: i < ch, or i % HALF < ch / 2 for 4 bits)
  auto chunk = [&](int i) {
    return BITS == 8 ? lane + 32 * i : (i < HALF ? 0 : hc) + lane + 32 * (i % HALF);
  };
  auto held = [&](int i) { return BITS == 8 ? i < ch : i % HALF < ch / 2; };
  uint4 raw[kWarpChunks];
#pragma unroll
  for (int i = 0; i < kWarpChunks; ++i)
    raw[i] = held(i) && chunk(i) < valid ? src[chunk(i)] : make_uint4(0u, 0u, 0u, 0u);

  uint32_t amax_bits = 0;
#pragma unroll
  for (int i = 0; i < kWarpChunks; ++i) {
    float v[VEC];
    unpack16(raw[i], v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax_bits = max(amax_bits, __float_as_uint(v[e]) & 0x7FFFFFFFu);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax_bits = max(amax_bits, __shfl_xor_sync(0xffffffffu, amax_bits, off));
  const float amax = __uint_as_float(amax_bits);
  const float sc = amax > 0.f ? __fdiv_rn(amax, static_cast<float>(qmax)) : 1.f;
  if (lane == 0) scale[b] = sc;

  if constexpr (BITS == 8) {
    uint8_t* out = q + b * gs;
#pragma unroll
    for (int i = 0; i < kWarpChunks; ++i) {
      if (!held(i)) continue;
      float v[VEC];
      unpack16(raw[i], v);
      uint8_t packed[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        packed[e] = static_cast<uint8_t>(static_cast<int8_t>(quantize_one(v[e], sc, qmax)));
      store_bytes<VEC>(out + chunk(i) * VEC, packed);
    }
  } else {
    uint8_t* out = q + b * (gs / 2);
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      if (!held(i)) continue;
      float lo[VEC], hi[VEC];
      unpack16(raw[i], lo);
      unpack16(raw[HALF + i], hi);
      uint8_t packed[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        packed[e] = static_cast<uint8_t>((quantize_one(lo[e], sc, qmax) & 0xF) |
                                         ((quantize_one(hi[e], sc, qmax) & 0xF) << 4));
      store_bytes<VEC>(out + chunk(i) * VEC, packed);
    }
  }
}

// ---------------------------------------------------------------------------
// the stream route of dequantize-reduce
// ---------------------------------------------------------------------------

constexpr int kStages = 8;             // ring depth of a stream block
constexpr int kConsumers = 4;          // consumer warps; warp w owns stages w and w + 4
constexpr int kStreamThreads = (kConsumers + 1) * 32;   // then the producer warp
constexpr int kStageBytes = 16384;     // the most one stage holds
constexpr int kMaxPeers = 8;           // dequantize-reduce's P, a template argument
static_assert(kStages % kConsumers == 0, "a stage is always read by the same warp");

// The dynamic shared memory of a stream block with stages of `stage` bytes:
// the stages, kMaxPeers scales per stage, then the full and empty barriers.
constexpr int stream_smem(int stage) { return kStages * (stage + 4 * kMaxPeers + 16); }

struct Ring {
  uint8_t* stages;
  float* scales;
  uint64_t* full;
  uint64_t* empty;
};

// Carves the ring out of dynamic shared memory; thread 0 initialises the
// barriers: `full` waits for `full_count` arrivals and the stage's bytes,
// `empty` for the one consumer warp that reads the stage.
__device__ __forceinline__ Ring make_ring(uint8_t* smem, int stage, int full_count) {
  Ring r;
  r.stages = smem;
  r.scales = reinterpret_cast<float*>(smem + kStages * stage);
  r.full = reinterpret_cast<uint64_t*>(r.scales + kStages * kMaxPeers);
  r.empty = r.full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&r.full[s], full_count);
      hopper::mbar_init(&r.empty[s], 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// The value of byte k of `w` as a signed 8-bit int, or of its low (HI
// false) or high nibble as a signed 4-bit int, as fp32 (exact).
__device__ __forceinline__ float byte_value(uint32_t w, int k) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * k)) >> 24);
}

template <bool HI>
__device__ __forceinline__ float nibble_value(uint32_t w, int k) {
  return static_cast<float>(static_cast<int>(w << (28 - 8 * k - (HI ? 4 : 0))) >> 28);
}

// The stream route of dequantize-reduce. Block i streams the output
// group-rows b = i, i + gridDim.x, ... (b = r * G + g of out [R, out_cols]);
// a stage holds the P wire rows q[p, b, :] (bulk copies) and the P scales
// scale[p, b] (cp.async by producer lanes 0 .. P-1, each arriving once on
// the stage's barrier). Lane steps of 4 wire bytes: 4 outputs for 8 bits,
// 4 low-nibble and 4 high-nibble outputs (gs / 2 apart) for 4.
template <int BITS, int P>
__global__ void __launch_bounds__(kStreamThreads)
dequant_reduce_stream(const uint8_t* __restrict__ q, const float* __restrict__ scale,
                      float* __restrict__ out, long long N, int G, int gs,
                      long long out_cols) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int gsw = BITS == 8 ? gs : gs / 2;
  const int stage = P * gsw;
  const Ring ring = make_ring(smem, stage, 1 + P);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == kConsumers) {   // the producer: lane 0 the rows, lanes < P a scale each
    if (lane >= P) return;
    int k = 0;
    for (long long b = blockIdx.x; b < N; b += gridDim.x, ++k) {
      const int s = k % kStages;
      if (k >= kStages) hopper::mbar_wait(&ring.empty[s], (k / kStages - 1) & 1);
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&ring.full[s], static_cast<uint32_t>(stage));
#pragma unroll
        for (int p = 0; p < P; ++p)
          hopper::bulk_load(ring.stages + s * stage + p * gsw, q + (p * N + b) * gsw,
                            static_cast<uint32_t>(gsw), &ring.full[s]);
      }
      hopper::cp_async4(ring.scales + s * kMaxPeers + lane, scale + lane * N + b, true);
      hopper::cp_async_arrive_noinc(&ring.full[s]);
    }
    return;
  }

  const int h = gs / 2;
  int k = warp;
  for (long long b = blockIdx.x + static_cast<long long>(warp) * gridDim.x; b < N;
       b += static_cast<long long>(kConsumers) * gridDim.x, k += kConsumers) {
    const int s = k % kStages;
    float* out_row = out + (b / G) * out_cols;
    const long long col0 = (b % G) * static_cast<long long>(gs);
    hopper::mbar_wait(&ring.full[s], (k / kStages) & 1);
    const uint8_t* st = ring.stages + s * stage;
    float sc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) sc[p] = ring.scales[s * kMaxPeers + p];
#pragma unroll 2
    for (int u = 4 * lane; u < gsw; u += 128) {
      uint32_t w[P];
#pragma unroll
      for (int p = 0; p < P; ++p) w[p] = *reinterpret_cast<const uint32_t*>(st + p * gsw + u);
      float acc[BITS == 8 ? 4 : 8];
#pragma unroll
      for (int i = 0; i < (BITS == 8 ? 4 : 8); ++i) acc[i] = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (BITS == 8) {
            acc[e] = __fadd_rn(acc[e], __fmul_rn(byte_value(w[p], e), sc[p]));
          } else {
            acc[e] = __fadd_rn(acc[e], __fmul_rn(nibble_value<false>(w[p], e), sc[p]));
            acc[4 + e] = __fadd_rn(acc[4 + e], __fmul_rn(nibble_value<true>(w[p], e), sc[p]));
          }
        }
      if (col0 + u < out_cols)
        *reinterpret_cast<float4*>(out_row + col0 + u) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      if constexpr (BITS == 4) {
        if (col0 + h + u < out_cols)
          *reinterpret_cast<float4*>(out_row + col0 + h + u) =
              make_float4(acc[4], acc[5], acc[6], acc[7]);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&ring.empty[s]);
  }
}

// ---------------------------------------------------------------------------
// host: routes, launches, the tally
// ---------------------------------------------------------------------------

// The kernels, in the order of the launch tally (ds_quant_kernel_launches).
enum Kernel {
  kQuantizeWarp,
  kQuantizeBlock,
  kDequantReduceStream,
  kDequantReduceBlock,
  kNumKernels
};
long long g_launches[kNumKernels] = {};

// The quantize kernel for rows of M elements of dtype (0 fp32, 2 bf16) in
// groups of gs at `bits`, x and q 16-byte aligned or not; -1 for arguments
// no kernel takes. The warp route holds a group in registers: its bytes are
// 1 to 8 KB in whole KB (an even number of 16-byte chunks a lane).
int quantize_route(long long M, int gs, int bits, int dtype, bool aligned) {
  if (M < 1 || gs < 1 || (bits != 8 && bits != 4) || (bits == 4 && gs % 2) ||
      (dtype != 0 && dtype != 2))
    return -1;
  const long long item = dtype == 0 ? 4 : 2;
  return gs * item % 1024 == 0 && gs * item <= 512 * kWarpChunks && M * item % 16 == 0 &&
                 aligned
             ? kQuantizeWarp
             : kQuantizeBlock;
}

// The dequantize-reduce kernel for P peers' groups of gs at `bits` into
// rows of out_cols fp32, q and out 16-byte aligned or not; -1 for
// arguments no kernel takes.
int dequant_route(int P, long long out_cols, int gs, int bits, bool aligned) {
  if (P < 1 || out_cols < 1 || gs < 1 || (bits != 8 && bits != 4) || (bits == 4 && gs % 2))
    return -1;
  const long long gsw = bits == 8 ? gs : gs / 2;
  return P <= kMaxPeers && gs % 256 == 0 && P * gsw <= kStageBytes && out_cols % 4 == 0 &&
                 aligned
             ? kDequantReduceStream
             : kDequantReduceBlock;
}

bool aligned16(const void* a, const void* b) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// Blocks of a stream kernel with `smem` bytes that one SM holds at once,
// asked of the runtime once per kernel, size and device; 0 if it cannot.
int resident_blocks(const void* kernel, int smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> known;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const auto key = std::make_tuple(kernel, smem, dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = known.find(key);
  if (hit != known.end()) return hit->second;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kStreamThreads, smem) !=
      cudaSuccess)
    return 0;
  known.emplace(key, n);
  return n;
}

// Launches a stream kernel over `items` groups: as many blocks as the card
// holds at once, but no more than kConsumers groups' worth.
template <typename Kern, typename... Args>
cudaError_t launch_stream(Kern kernel, int stage, long long items, cudaStream_t s,
                          Args... args) {
  const int smem = stream_smem(stage);
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t e = hopper::allow_smem(fn, smem);
  if (e != cudaSuccess) return e;
  const long long per_sm = resident_blocks(fn, smem);
  const long long sms = hopper::sm_count();
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  const long long wanted = (items + kConsumers - 1) / kConsumers;
  const unsigned grid = static_cast<unsigned>(wanted < per_sm * sms ? wanted : per_sm * sms);
  kernel<<<grid, kStreamThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_quantize(const void* x, void* q, void* scale, long long R, long long M,
                            int G, int gs, int bits, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(R * G);
  if (bits == 8)
    quantize_block<T, VEC, 8><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<uint8_t*>(q), static_cast<float*>(scale), M, G, gs);
  else
    quantize_block<T, VEC, 4><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<uint8_t*>(q), static_cast<float*>(scale), M, G, gs);
  return cudaGetLastError();
}

template <typename T, int VEC>
bool vector_ok(const void* x, const void* q, long long M, int gs, int bits) {
  const int unit = bits == 8 ? VEC : 2 * VEC;   // whole vectors per (half-)group
  return M % VEC == 0 && gs % unit == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

template <typename T>
cudaError_t launch_quantize_warp(const void* x, void* q, void* scale, long long R, long long M,
                                 int G, int gs, int bits, cudaStream_t s) {
  const long long n = R * G;
  const unsigned blocks = static_cast<unsigned>((n + kThreads / 32 - 1) / (kThreads / 32));
  const T* xx = static_cast<const T*>(x);
  uint8_t* qq = static_cast<uint8_t*>(q);
  float* ss = static_cast<float*>(scale);
  if (bits == 8)
    quantize_warp<T, 8><<<blocks, kThreads, 0, s>>>(xx, qq, ss, M, G, gs, n);
  else
    quantize_warp<T, 4><<<blocks, kThreads, 0, s>>>(xx, qq, ss, M, G, gs, n);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_dequant_stream(const uint8_t* q, const float* scale, float* out, int P,
                                  long long N, int G, int gs, long long out_cols,
                                  cudaStream_t s) {
  const int stage = P * (BITS == 8 ? gs : gs / 2);
  switch (P) {
#define DS_DEQ_CASE(NP)                                                                     \
  case NP:                                                                                  \
    return launch_stream(dequant_reduce_stream<BITS, NP>, stage, N, s, q, scale, out, N, G, \
                         gs, out_cols);
    DS_DEQ_CASE(1)
    DS_DEQ_CASE(2)
    DS_DEQ_CASE(3)
    DS_DEQ_CASE(4)
    DS_DEQ_CASE(5)
    DS_DEQ_CASE(6)
    DS_DEQ_CASE(7)
    DS_DEQ_CASE(8)
#undef DS_DEQ_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [R, M] (dtype 0 = fp32, 2 = bf16), row-major and contiguous;
// q [R, G * gsw] uint8 (gsw = gs for 8 bits, gs / 2 for 4); scale [R, G] fp32;
// G = ceil(M / gs). Launches the route's kernel (quantize_route) and returns
// a cudaError_t (0 on success).
int ds_block_quantize(const void* x, void* q, void* scale, long long R, long long M, int G,
                      int gs, int bits, int dtype, void* stream) {
  if (R < 1 || M < 1 || gs < 1 || G != (M + gs - 1) / gs || (bits != 8 && bits != 4) ||
      (bits == 4 && gs % 2) || R * G > 0x7fffffffLL || (dtype != 0 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = quantize_route(M, gs, bits, dtype, aligned16(x, q));
  cudaError_t e;
  if (k == kQuantizeWarp)
    e = dtype == 0 ? launch_quantize_warp<float>(x, q, scale, R, M, G, gs, bits, s)
                   : launch_quantize_warp<__nv_bfloat16>(x, q, scale, R, M, G, gs, bits, s);
  else if (dtype == 0)
    e = vector_ok<float, 4>(x, q, M, gs, bits)
            ? launch_quantize<float, 4>(x, q, scale, R, M, G, gs, bits, s)
            : launch_quantize<float, 1>(x, q, scale, R, M, G, gs, bits, s);
  else
    e = vector_ok<__nv_bfloat16, 8>(x, q, M, gs, bits)
            ? launch_quantize<__nv_bfloat16, 8>(x, q, scale, R, M, G, gs, bits, s)
            : launch_quantize<__nv_bfloat16, 1>(x, q, scale, R, M, G, gs, bits, s);
  if (e == cudaSuccess) ++g_launches[k];
  return static_cast<int>(e);
}

// q [P, R * G, gsw] uint8, scale [P, R * G] fp32 -> out [R, out_cols] fp32,
// out[r, g * gs + e] = sum over p in order of dequant(q[p, r * G + g, .])[e],
// for g * gs + e < out_cols (out_cols <= G * gs). Launches the route's
// kernel (dequant_route).
int ds_block_dequantize_reduce(const void* q, const void* scale, void* out, int P, long long R,
                               int G, int gs, long long out_cols, int bits, void* stream) {
  if (P < 1 || R < 1 || G < 1 || gs < 1 || (bits != 8 && bits != 4) || (bits == 4 && gs % 2) ||
      out_cols < 1 || out_cols > static_cast<long long>(G) * gs || R * G > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long N = R * G;
  const int gsw = bits == 8 ? gs : gs / 2;
  const uint8_t* qq = static_cast<const uint8_t*>(q);
  const float* ss = static_cast<const float*>(scale);
  float* oo = static_cast<float*>(out);
  const int k = dequant_route(P, out_cols, gs, bits, aligned16(q, out));
  cudaError_t e;
  if (k == kDequantReduceStream) {
    e = bits == 8 ? launch_dequant_stream<8>(qq, ss, oo, P, N, G, gs, out_cols, s)
                  : launch_dequant_stream<4>(qq, ss, oo, P, N, G, gs, out_cols, s);
  } else {
    const unsigned blocks = static_cast<unsigned>(N);
    const bool word = gsw % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
    const bool vec_store = out_cols % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (bits == 8) {
      if (word)
        dequant_reduce_block<8, 4><<<blocks, kThreads, 0, s>>>(qq, ss, oo, P, N, G, gs, out_cols, vec_store);
      else
        dequant_reduce_block<8, 1><<<blocks, kThreads, 0, s>>>(qq, ss, oo, P, N, G, gs, out_cols, false);
    } else {
      if (word)
        dequant_reduce_block<4, 4><<<blocks, kThreads, 0, s>>>(qq, ss, oo, P, N, G, gs, out_cols, vec_store);
      else
        dequant_reduce_block<4, 1><<<blocks, kThreads, 0, s>>>(qq, ss, oo, P, N, G, gs, out_cols, false);
    }
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) ++g_launches[k];
  return static_cast<int>(e);
}

// The kernel (an index of enum Kernel, the tally's order) that a call
// launches: op 0 quantize (len = M, dtype 0 fp32 / 2 bf16), op 1
// dequantize-reduce (len = out_cols, P peers); `aligned` says whether its
// data pointers are 16-byte aligned. -1 for arguments no kernel takes.
int ds_quant_route(int op, long long len, int gs, int bits, int dtype, int P, int aligned) {
  if (op == 0) return quantize_route(len, gs, bits, dtype, aligned != 0);
  if (op == 1) return dequant_route(P, len, gs, bits, aligned != 0);
  return -1;
}

// Launches so far of one kernel, in the order of enum Kernel; -1 past the end.
long long ds_quant_kernel_launches(int kernel) {
  return kernel >= 0 && kernel < kNumKernels ? g_launches[kernel] : -1;
}

const char* ds_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
