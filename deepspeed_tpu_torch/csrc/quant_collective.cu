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
// What the design does about it. The TPU kernel walks a grid of 64-group
// blocks through VMEM. Here one block of 256 threads owns one group: it
// reduces the group's amax (warp shuffles, then one shared-memory step),
// then quantizes; the second pass rereads the group (8 KB in fp32) from
// L1/L2, so device memory is read once. Loads are 16 bytes a thread (4 fp32
// or 8 bf16) where the row length and group size allow it, else one element
// a thread; for 4-bit a thread loads elements j..j+VEC-1 and
// j+gs/2..j+gs/2+VEC-1, so it holds both nibbles of its bytes before it packs
// them. The reduction kernel gives each thread 4 wire bytes of a group and
// walks the peers in order with fp32 accumulators in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// One block per group-row b = r * G + g: elements [g * gs, (g + 1) * gs) of
// row r of x [R, M]. Writes q[b * gsw ...] and scale[b].
template <typename T, int VEC, int BITS>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ scale,
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

// One block per group-row b = r * G + g of the output [R, out_cols]: sums
// the P peers' dequantized groups b (wire q [P, R * G, gsw], scales
// [P, R * G]) in peer order. WORD bytes of wire per thread step: 4 when the
// wire width allows aligned 4-byte loads, else 1.
template <int BITS, int WORD>
__global__ void __launch_bounds__(kThreads)
dequant_reduce_kernel(const uint8_t* __restrict__ q, const float* __restrict__ scale,
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

template <typename T, int VEC>
cudaError_t launch_quantize(const void* x, void* q, void* scale, long long R, long long M,
                            int G, int gs, int bits, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(R * G);
  if (bits == 8)
    quantize_kernel<T, VEC, 8><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<uint8_t*>(q), static_cast<float*>(scale), M, G, gs);
  else
    quantize_kernel<T, VEC, 4><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<uint8_t*>(q), static_cast<float*>(scale), M, G, gs);
  return cudaGetLastError();
}

template <typename T, int VEC>
bool vector_ok(const void* x, const void* q, long long M, int gs, int bits) {
  const int unit = bits == 8 ? VEC : 2 * VEC;   // whole vectors per (half-)group
  return M % VEC == 0 && gs % unit == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

}  // namespace

extern "C" {

// x [R, M] (dtype 0 = fp32, 2 = bf16), row-major and contiguous;
// q [R, G * gsw] uint8 (gsw = gs for 8 bits, gs / 2 for 4); scale [R, G] fp32;
// G = ceil(M / gs). Returns a cudaError_t (0 on success).
int ds_block_quantize(const void* x, void* q, void* scale, long long R, long long M, int G,
                      int gs, int bits, int dtype, void* stream) {
  if (R < 1 || M < 1 || gs < 1 || G != (M + gs - 1) / gs || (bits != 8 && bits != 4) ||
      (bits == 4 && gs % 2) || R * G > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(vector_ok<float, 4>(x, q, M, gs, bits)
                                ? launch_quantize<float, 4>(x, q, scale, R, M, G, gs, bits, s)
                                : launch_quantize<float, 1>(x, q, scale, R, M, G, gs, bits, s));
  if (dtype == 2)
    return static_cast<int>(
        vector_ok<__nv_bfloat16, 8>(x, q, M, gs, bits)
            ? launch_quantize<__nv_bfloat16, 8>(x, q, scale, R, M, G, gs, bits, s)
            : launch_quantize<__nv_bfloat16, 1>(x, q, scale, R, M, G, gs, bits, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// q [P, R * G, gsw] uint8, scale [P, R * G] fp32 -> out [R, out_cols] fp32,
// out[r, g * gs + e] = sum over p in order of dequant(q[p, r * G + g, .])[e],
// for g * gs + e < out_cols (out_cols <= G * gs).
int ds_block_dequantize_reduce(const void* q, const void* scale, void* out, int P, long long R,
                               int G, int gs, long long out_cols, int bits, void* stream) {
  if (P < 1 || R < 1 || G < 1 || gs < 1 || (bits != 8 && bits != 4) || (bits == 4 && gs % 2) ||
      out_cols < 1 || out_cols > static_cast<long long>(G) * gs || R * G > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long N = R * G;
  const unsigned blocks = static_cast<unsigned>(N);
  const int gsw = bits == 8 ? gs : gs / 2;
  const bool word = gsw % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  const bool vec_store = out_cols % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const uint8_t* qq = static_cast<const uint8_t*>(q);
  const float* ss = static_cast<const float*>(scale);
  float* oo = static_cast<float*>(out);
  if (bits == 8) {
    if (word)
      dequant_reduce_kernel<8, 4><<<blocks, kThreads, 0, s>>>(qq, ss, oo, P, N, G, gs, out_cols, vec_store);
    else
      dequant_reduce_kernel<8, 1><<<blocks, kThreads, 0, s>>>(qq, ss, oo, P, N, G, gs, out_cols, false);
  } else {
    if (word)
      dequant_reduce_kernel<4, 4><<<blocks, kThreads, 0, s>>>(qq, ss, oo, P, N, G, gs, out_cols, vec_store);
    else
      dequant_reduce_kernel<4, 1><<<blocks, kThreads, 0, s>>>(qq, ss, oo, P, N, G, gs, out_cols, false);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ds_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
