// Grouped GEMM over expert-sorted rows (the MoE expert FFN's three products)
// for Hopper (sm_90a). Built by deepspeed_tpu_torch/ops/cuda_build.py with
// nvcc into a shared library with a plain C interface, called through ctypes
// by deepspeed_tpu_torch/ops/grouped_gemm.py::grouped_matmul.
//
// Replaces the TPU kernel reached from deepspeed_tpu/ops/pallas/grouped_gemm.py
// (`_moe_ffn_gmm_local`, whose three megablox `gmm` calls reach
// pl.pallas_call; public entry `moe_ffn_gmm`). Same function:
//   out[r, :] = xs[r, :] @ w[e(r)] for rows already sorted by expert, with
//   xs [R, K] and w [E, K, N] in bf16, fp16 or fp32, and e(r) the expert whose
//   range group_offsets[e] <= r < group_offsets[e + 1] holds r
//   (group_offsets [E + 1] int32 on the device); fp32 accumulation, rounded
//   once to the dtype (megablox gmm with preferred_element_type=float32,
//   then .astype(dtype)).
//
// What bounds it on the H100. A decode round has few rows per expert
// (R = 2 x tokens spread over 8 experts): every touched expert's [K, N]
// weights are read once for a handful of rows, so it is bound by HBM bytes
// (Mixtral-8x7B: up to 8 x 4096 x 14336 x 2 B = 0.94 GB per product, 0.28 ms
// at 3.35 TB/s). A SplitFuse round with thousands of rows per expert does
// 2 R K N operations on the same bytes and is bound by the tensor cores
// (2 x 8192 x 4096 x 14336 = 0.96 TFLOP, 0.97 ms at 989 TFLOP/s).
//
// What the design does about it. The TPU kernel walks a sequential grid
// whose group metadata (which tile belongs to which expert) megablox
// computes on the host side of the trace, and pads the rows to its 128-row
// tile. Here blocks run in no order, so:
//   - the grid is sized for the worst case without reading the group sizes
//     on the host: ceil(R / 128) + E row tiles by ceil(N / 128) column tiles.
//     Each block walks group_offsets on the device (E is small: a linear
//     scan), finds its (expert, rows) and exits when it has none. A forward
//     costs no host sync;
//   - tiles of 128 rows x 128 columns, 8 warps of 64 x 32; K is walked in
//     steps of 32 through a 3-stage ring of cp.async copies into shared
//     memory (rows padded by 16 bytes so ldmatrix reads hit distinct banks);
//   - bf16/fp16 products run on the tensor cores with mma.sync m16n8k16
//     (fp32 accumulators); products of two bf16/fp16 values are exact in
//     fp32, so kernel and plain version differ only in summation order
//     before the one rounding. B stays in the JAX layout [K, N] and is
//     transposed into the mma fragment by ldmatrix.trans;
//   - ragged edges are masked in the kernel: rows past the group's end and
//     K/N past the matrix are zero-filled by cp.async (src-size 0) and never
//     stored, so nothing is padded. K and N must be multiples of 8 (16-byte
//     copies);
//   - fp32 inputs take a separate SIMT kernel (64 x 64 tiles, FMAs on CUDA
//     cores): TF32 tensor cores would round the inputs.
// This is the simple, correct first kernel: wgmma, TMA, warp specialisation
// and a smaller row tile for decode are later work.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;            // rows per block tile
constexpr int kBN = 128;            // columns per block tile
constexpr int kBK = 32;             // K per pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;       // 8 warps: 2 (rows) x 4 (columns)
// rows padded by 16 bytes (80 and 272 bytes): the 8 rows one ldmatrix reads
// start in 8 different 16-byte bank groups
constexpr int kPadA = kBK + 8;
constexpr int kPadB = kBN + 8;
constexpr int kStageA = kBM * kPadA;
constexpr int kStageB = kBK * kPadB;
constexpr int kSmemBytes = kStages * (kStageA + kStageB) * 2;

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

// bf16 / fp16: tensor-core tiles. Block (row tile, column tile); warp
// (wm, wn) owns rows wm*64 .. +64 and columns wn*32 .. +32 of the block tile
// as 4 x 4 mma tiles of 16 x 8.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_gemm_mma_kernel(const T* __restrict__ xs, const T* __restrict__ w,
                            const int* __restrict__ offsets, T* __restrict__ out, int K, int N,
                            int E) {
  int expert, row0, row1;
  if (!find_tile<kBM>(offsets, E, blockIdx.x, expert, row0, row1)) return;
  const int n0 = blockIdx.y * kBN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);  // [kStages][kBM][kPadA]
  T* sB = sA + kStages * kStageA;          // [kStages][kBK][kPadB]
  const T* wE = w + static_cast<int64_t>(expert) * K * N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;

  // one stage: A 128 rows x 32 K and B 32 K x 128 columns, 512 16-byte
  // chunks each, two of each per thread
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    T* a = sA + stage * kStageA;
    T* b = sB + stage * kStageB;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int ar = c >> 2, ak = (c & 3) * 8;
      const int gr = row0 + ar, gk = k0 + ak;
      const bool a_ok = gr < row1 && gk < K;
      cp_async16(a + ar * kPadA + ak, a_ok ? xs + static_cast<int64_t>(gr) * K + gk : xs, a_ok);
      const int br = c >> 4, bn = (c & 15) * 8;
      const int gbk = k0 + br, gn = n0 + bn;
      const bool b_ok = gbk < K && gn < N;
      cp_async16(b + br * kPadB + bn, b_ok ? wE + static_cast<int64_t>(gbk) * N + gn : w, b_ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int k_tiles = (K + kBK - 1) / kBK;
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
    const T* a = sA + (kt % kStages) * kStageA;
    const T* b = sB + (kt % kStages) * kStageB;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a + (wm * 64 + mi * 16 + (lane & 15)) * kPadA + ks + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {  // one x4.trans: two n8 tiles, k 0-7 and 8-15
        uint32_t t[4];
        ldmatrix_x4_trans(t, b + (ks + (lane & 15)) * kPadB + wn * 32 + nj * 16 + (lane >> 4) * 8);
        bf[2 * nj][0] = t[0];
        bf[2 * nj][1] = t[1];
        bf[2 * nj + 1][0] = t[2];
        bf[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) Tc<T>::mma(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  // accumulator (mi, ni): rows g and g + 8, columns 2 tg and 2 tg + 1 of
  // the 16 x 8 tile; N % 8 == 0 keeps each pair inside or outside together
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= row1) continue;
      T* orow = out + static_cast<int64_t>(row) * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + tg * 2;
        if (col < N) Tc<T>::store2(orow + col, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

constexpr int kSimtBM = 64;
constexpr int kSimtBN = 64;
constexpr int kSimtBK = 16;

// fp32: FMAs on CUDA cores, 64 x 64 tiles, 4 x 4 outputs per thread at a
// stride of 16 so that shared-memory reads of a warp hit distinct banks.
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_fp32_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                             const int* __restrict__ offsets, float* __restrict__ out, int K,
                             int N, int E) {
  int expert, row0, row1;
  if (!find_tile<kSimtBM>(offsets, E, blockIdx.x, expert, row0, row1)) return;
  const int n0 = blockIdx.y * kSimtBN;
  __shared__ float As[kSimtBK][kSimtBM + 4];  // [k][row]
  __shared__ float Bs[kSimtBK][kSimtBN];      // [k][column]
  const float* wE = w + static_cast<int64_t>(expert) * K * N;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kSimtBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kThreads;
      const int ar = c >> 4, ak = c & 15;
      const int gr = row0 + ar, gk = k0 + ak;
      As[ak][ar] = (gr < row1 && gk < K) ? xs[static_cast<int64_t>(gr) * K + gk] : 0.f;
      const int br = c >> 6, bn = c & 63;
      const int gbk = k0 + br, gn = n0 + bn;
      Bs[br][bn] = (gbk < K && gn < N) ? wE[static_cast<int64_t>(gbk) * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
      if (col < N) out[static_cast<int64_t>(row) * N + col] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t launch_mma(const void* xs, const void* w, const void* offsets, void* out, int R,
                       int K, int N, int E, cudaStream_t stream) {
  // above 48 KB of shared memory only as dynamic shared memory, once opted in;
  // the attribute is per device, so it is set before every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      grouped_gemm_mma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((R + kBM - 1) / kBM + E, (N + kBN - 1) / kBN);
  grouped_gemm_mma_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(w), static_cast<const int*>(offsets),
      static_cast<T*>(out), K, N, E);
  return cudaGetLastError();
}

}  // namespace

// xs [R, K], w [E, K, N], group_offsets [E + 1] int32, out [R, N], all on
// the device and contiguous; dtype 0 = fp32, 1 = fp16, 2 = bf16. Launches on
// `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int ds_grouped_matmul(const void* xs, const void* w, const void* group_offsets,
                                 void* out, int R, int K, int N, int E, int dtype,
                                 void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: {
      const dim3 grid((R + kSimtBM - 1) / kSimtBM + E, (N + kSimtBN - 1) / kSimtBN);
      grouped_gemm_fp32_kernel<<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(xs), static_cast<const float*>(w),
          static_cast<const int*>(group_offsets), static_cast<float*>(out), K, N, E);
      err = cudaGetLastError();
      break;
    }
    case 1:
      err = launch_mma<__half>(xs, w, group_offsets, out, R, K, N, E, s);
      break;
    case 2:
      err = launch_mma<__nv_bfloat16>(xs, w, group_offsets, out, R, K, N, E, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
