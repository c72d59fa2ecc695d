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
// 574 GFLOP over 0.54 GB: bound by operations, 0.58 ms at 989 TFLOP/s. This
// first kernel does its products with fp32 FMAs on the CUDA cores (67
// TFLOP/s peak), like the flash kernels, so it runs far from that bound;
// mma.sync / wgmma tiles fed by TMA are later work.
//
// Design. The TPU grid runs (b, h, iq, j) with j, the enabled-block slot,
// innermost and sequential, carrying m, l and acc in VMEM scratch across j;
// the K/V index maps read cols so that only enabled blocks are fetched. Here
// one thread block of 256 threads (a 16 x 16 grid) owns BQ query rows of one
// query block of one head of one batch row, reads its own counts and cols,
// and loops over its enabled key blocks:
//   - a key block is staged whole (BK >= block rows, the rows past block are
//     absent: p = 0), so the running maximum, and with it the rounding of p,
//     is the TPU kernel's, block by block;
//   - q rows, then K and V in turn, are staged in shared memory as fp32 rows
//     padded by 4 floats; each thread computes a 4 x 4 (or smaller) block of
//     the score tile with float4 shared loads, row max and sum are shuffles
//     over the 16 lanes of a row, and the output accumulators live in
//     registers, columns tx * 4 + 64 c;
//   - blocks up to 128 and D up to 256 need up to 183 KB of shared memory,
//     taken as dynamic shared memory after cudaFuncSetAttribute; the launch
//     error is returned to the wrapper, which raises.
// Blocks above 128 are refused here (the wrapper raises before launching).
// A BigBird global query row visits every key block while the others visit a
// few, so the thread blocks of those rows finish last: a tail this simple
// grid does not balance.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

// Mirrored field by field by _SparseParams in ops/block_sparse_attention.py.
struct DsSparseParams {
  const void* q;
  const void* k;
  const void* v;
  const int* cols;                   // [H, nq, C] int32
  const int* counts;                 // [H, nq] int32
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
cudaError_t dispatch_width(const Params& p, cudaStream_t s) {
  if (p.dh <= 0 || p.dh > 256) return cudaErrorInvalidValue;
  if (p.dh <= 64) return dispatch_block<T, 64>(p, s);
  if (p.dh <= 128) return dispatch_block<T, 128>(p, s);
  return dispatch_block<T, 256>(p, s);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, k, v and the output
// share it). Returns a cudaError_t code.
extern "C" int ds_block_sparse_fwd(const Params* p, int dtype, void* stream) {
  if (p->B == 0 || p->H == 0 || p->S == 0) return cudaSuccess;
  if (p->block <= 0 || p->block % 8 || p->S != p->nq * p->block || p->C < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_width<float>(*p, s);
    case 1: return dispatch_width<__half>(*p, s);
    case 2: return dispatch_width<__nv_bfloat16>(*p, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_block_sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
