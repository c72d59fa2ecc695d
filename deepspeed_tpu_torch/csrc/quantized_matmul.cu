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
// the dequantized weight rounded once to T (the tile dtype), the products
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
// What the design does about it. The TPU kernel walks a sequential grid
// (M/bm, N/bn, K/bk) with an fp32 accumulator carried in VMEM across the K
// steps, and refuses K % 512, N % 256 and M % 8 remainders. Here:
//   - the int8 weight is what crosses HBM: each stage copies a [32][128]
//     int8 tile of q (16-byte cp.async, 8 per row) and its [32][8] scales
//     (one per 16-column chunk: G % 16 == 0) into shared memory; the threads
//     then dequantize it into a [32][128] T tile (one rounding to T), from
//     which ldmatrix.trans builds the mma.sync m16n8k16 B fragments; x is
//     copied as [BM][32] T tiles through the same 4-stage cp.async ring;
//   - two block shapes: 16 x 128 outputs with 4 warps for M <= 16 (decode),
//     128 x 128 with 8 warps otherwise; rows past M, K past the split's end
//     and columns past N are zero-filled by cp.async and never stored, so
//     any M >= 1 and K % 8 == 0 are taken (Llama's down_proj has K = 11008);
//   - at small M one block per column tile would leave most of the 132 SMs
//     idle, so K is split over `splits` blocks (the wrapper sizes it to fill
//     the card): each writes its fp32 partial sums to a workspace and a
//     second kernel adds them in split order and rounds once. No atomics:
//     the result is deterministic;
//   - products of two bf16/fp16 values are exact in fp32, so the kernel and
//     the plain version differ only in the order of the fp32 sums.
// This is the simple, correct first kernel: wgmma, TMA, dequantizing
// straight into registers and a tuned decode path are later work.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int kBN = 128;             // columns per block tile
constexpr int kBK = 32;              // contraction per pipeline stage
constexpr int kStages = 4;
constexpr int kChunks = kBN / 16;    // 16-column chunks of a q row
// rows padded by 16 bytes (80 and 272 bytes): the 8 rows one ldmatrix reads
// start in 8 different 16-byte bank groups
constexpr int kPadA = kBK + 8;       // x tile [BM][32]
constexpr int kPadB = kBN + 8;       // dequantized tile [32][128]
constexpr int kQTile = kBK * kBN;    // int8 bytes of a q tile
constexpr int kSTile = kBK * kChunks;  // scales of a q tile

template <int BM>
struct Shape {
  static constexpr int kWarpsM = BM == 16 ? 1 : 2;
  static constexpr int kWarpsN = 4;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kMI = BM / kWarpsM / 16;   // 16-row mma tiles per warp
  static constexpr int kStageBytes = BM * kPadA * 2 + kQTile + kSTile * 4;
  static constexpr int kSmemBytes = kStages * kStageBytes + kBK * kPadB * 2;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
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
  // two fp32 values rounded to nearest even, packed low-first
  static __device__ __forceinline__ uint32_t pack2(float x, float y) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&v);
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
  static __device__ __forceinline__ uint32_t pack2(float x, float y) {
    const __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

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

// out (or the split's fp32 partial) [M, N] = x [M, K] @ T(q * scale) over
// the contraction range [blockIdx.z * k_split, +k_split) of K. Block
// (column tile, row tile, split); warp (wm, wn) owns rows wm * BM / kWarpsM
// and columns wn * 32 of the block tile, as kMI x 4 mma tiles of 16 x 8.
template <typename T, typename O, int BM>
__global__ void __launch_bounds__(Shape<BM>::kThreads, 2)
    quantized_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                            const float* __restrict__ scale, O* __restrict__ out,
                            float* __restrict__ partial, int M, int K, int N, int G,
                            int k_split) {
  using S = Shape<BM>;
  constexpr int kThreads = S::kThreads;
  constexpr int kMI = S::kMI;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_split;
  const int kend = min(kbeg + k_split, K);
  const int NG = N / G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw + kStages * S::kStageBytes);  // [kBK][kPadB]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;

  auto stage_a = [&](int st) {
    return reinterpret_cast<T*>(smem_raw + st * S::kStageBytes);
  };
  auto stage_q = [&](int st) {
    return reinterpret_cast<int8_t*>(smem_raw + st * S::kStageBytes + BM * kPadA * 2);
  };
  auto stage_s = [&](int st) {
    return reinterpret_cast<float*>(smem_raw + st * S::kStageBytes + BM * kPadA * 2 + kQTile);
  };

  auto load_stage = [&](int st, int kt) {
    const int k0 = kbeg + kt * kBK;
    T* sa = stage_a(st);
    int8_t* sq = stage_q(st);
    float* ss = stage_s(st);
    for (int c = tid; c < BM * (kBK / 8); c += kThreads) {
      const int ar = c >> 2, ak = (c & 3) * 8;
      const int gm = m0 + ar, gk = k0 + ak;
      const bool ok = gm < M && gk < kend;
      cp_async16(sa + ar * kPadA + ak, ok ? x + static_cast<int64_t>(gm) * K + gk : x, ok);
    }
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int r = c / kChunks, cc = c % kChunks;
      const int gk = k0 + r, gn = n0 + cc * 16;
      const bool ok = gk < kend && gn < N;
      cp_async16(sq + r * kBN + cc * 16, ok ? q + static_cast<int64_t>(gk) * N + gn : q, ok);
      cp_async4(ss + c, ok ? scale + static_cast<int64_t>(gk) * NG + gn / G : scale, ok);
    }
  };

  // dequantize a landed stage into sB: 16 int8 values and their scale per
  // chunk, each float(q) * scale rounded once to T
  auto dequantize = [&](int st) {
    const int8_t* sq = stage_q(st);
    const float* ss = stage_s(st);
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int r = c / kChunks, cc = c % kChunks;
      const int4 raw = *reinterpret_cast<const int4*>(sq + r * kBN + cc * 16);
      const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
      const float sc = ss[c];
      uint32_t packed[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        packed[j] = Tc<T>::pack2(static_cast<float>(v[2 * j]) * sc,
                                 static_cast<float>(v[2 * j + 1]) * sc);
      uint4* dst = reinterpret_cast<uint4*>(sB + r * kPadB + cc * 16);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
  };

  float acc[kMI][4][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int k_tiles = (max(kend - kbeg, 0) + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  const char* sb_bytes = reinterpret_cast<const char*>(sB);
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    // stage kt has landed for every thread; every warp is done with the
    // stage the next copy overwrites and with sB (both read at kt - 1)
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();
    dequantize(kt % kStages);
    __syncthreads();
    const char* sa = reinterpret_cast<const char*>(stage_a(kt % kStages));
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[kMI][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
        ldmatrix_x4(af[mi], sa + ((wm * kMI * 16 + mi * 16 + (lane & 15)) * kPadA + ks +
                                  (lane >> 4) * 8) * 2);
      // B stored [contraction][column]: ldmatrix.trans; matrices
      // (c 0-7, n 0-7), (c 8-15, n 0-7), (c 0-7, n 8-15), (c 8-15, n 8-15)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sb_bytes + ((ks + (lane & 15)) * kPadB + wn * 32 + nj * 16 +
                                         (lane >> 4) * 8) * 2);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) Tc<T>::mma(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  // accumulator (mi, ni): rows g and g + 8, columns 2 tg and 2 tg + 1 of the
  // 16 x 8 tile; N % 16 == 0 keeps each pair inside or outside together
  const int g = lane >> 2, tg = lane & 3;
  float* part = partial == nullptr ? nullptr
                                   : partial + static_cast<int64_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * kMI * 16 + mi * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + tg * 2;
        if (col >= N) continue;
        const int64_t at = static_cast<int64_t>(row) * N + col;
        if (part != nullptr)
          Out<float>::store2(part + at, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        else
          Out<O>::store2(out + at, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

// out[i] = cast(sum over splits, in split order, of partial[s][i])
template <typename O>
__global__ void split_reduce_kernel(const float* __restrict__ partial, O* __restrict__ out,
                                    int64_t count, int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += partial[s * count + i];
    out[i] = Out<O>::cast(sum);
  }
}

template <typename T, typename O, int BM>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, void* workspace,
                   int M, int K, int N, int G, int splits, int k_split, cudaStream_t stream) {
  using S = Shape<BM>;
  // the attribute is per device, so it is set before every launch
  const cudaError_t attr =
      cudaFuncSetAttribute(quantized_matmul_kernel<T, O, BM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  float* partial = splits > 1 ? static_cast<float*>(workspace) : nullptr;
  quantized_matmul_kernel<T, O, BM><<<grid, S::kThreads, S::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<O*>(out), partial, M, K, N, G, k_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t count = static_cast<int64_t>(M) * N;
  const int64_t wanted = (count + 255) / 256;
  const int blocks = static_cast<int>(wanted < 4096 ? wanted : 4096);
  split_reduce_kernel<O><<<blocks, 256, 0, stream>>>(partial, static_cast<O*>(out), count,
                                                     splits);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t launch_bm(int bm, const void* x, const void* q, const void* scale, void* out,
                      void* workspace, int M, int K, int N, int G, int splits, int k_split,
                      cudaStream_t stream) {
  if (bm == 16)
    return launch<T, O, 16>(x, q, scale, out, workspace, M, K, N, G, splits, k_split, stream);
  if (bm == 128)
    return launch<T, O, 128>(x, q, scale, out, workspace, M, K, N, G, splits, k_split, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_out(int out_dtype, int bm, const void* x, const void* q, const void* scale,
                       void* out, void* workspace, int M, int K, int N, int G, int splits,
                       int k_split, cudaStream_t stream) {
  switch (out_dtype) {
    case 0:
      return launch_bm<T, float>(bm, x, q, scale, out, workspace, M, K, N, G, splits, k_split,
                                 stream);
    case 1:
      return launch_bm<T, __half>(bm, x, q, scale, out, workspace, M, K, N, G, splits,
                                  k_split, stream);
    case 2:
      return launch_bm<T, __nv_bfloat16>(bm, x, q, scale, out, workspace, M, K, N, G, splits,
                                         k_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out [M, N] = x [M, K] @ dequant(q [K, N] int8, scale [K, N / G] fp32),
// all on the device and contiguous. x_dtype 1 = fp16, 2 = bf16 (also the
// dtype the weight tile is rounded to); out_dtype 0 = fp32, 1 = fp16,
// 2 = bf16. bm (16 or 128) is the block's row tile; K is split over
// `splits` blocks of k_split (a multiple of 32) contraction elements each,
// whose fp32 partial sums go to `workspace` [splits, M, N] when splits > 1.
// Needs K % 8 == 0, N % G == 0 and G % 16 == 0. Launches on `stream` and
// returns the launch's cudaError_t (0 = success).
extern "C" int ds_quantized_matmul(const void* x, const void* q, const void* scale, void* out,
                                   void* workspace, int M, int K, int N, int group_size,
                                   int x_dtype, int out_dtype, int bm, int splits, int k_split,
                                   void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || group_size <= 0 || K % 8 || group_size % 16 ||
      N % group_size || splits <= 0 || k_split <= 0 || k_split % kBK ||
      static_cast<int64_t>(splits) * k_split < K || (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (x_dtype) {
    case 1:
      err = launch_out<__half>(out_dtype, bm, x, q, scale, out, workspace, M, K, N, group_size,
                               splits, k_split, s);
      break;
    case 2:
      err = launch_out<__nv_bfloat16>(out_dtype, bm, x, q, scale, out, workspace, M, K, N,
                                      group_size, splits, k_split, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
