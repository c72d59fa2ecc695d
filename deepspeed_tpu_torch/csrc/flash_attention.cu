// Flash attention forward, dq and dk/dv for Hopper (sm_90a). Built by
// deepspeed_tpu_torch/ops/cuda_build.py with nvcc into a shared library with
// a plain C interface, called through ctypes by
// deepspeed_tpu_torch/ops/flash_attention.py (flash_mha_fwd,
// flash_mha_bwd_dq, flash_mha_bwd_dkv, and the autograd Function flash_mha).
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   ds_flash_fwd     <- _fwd_kernel     (pl.pallas_call in _fwd, :380)
//   ds_flash_bwd_dq  <- _bwd_dq_kernel  (pl.pallas_call in _bwd, :549)
//   ds_flash_bwd_dkv <- _bwd_dkv_kernel (pl.pallas_call in _bwd, :572)
// Same function: q [B, Tq, H, Dh], k/v [B, Tk, KV, Dh] with H % KV == 0
// (query head h reads kv head h / (H / KV)), Dh <= 256; logits
// s = q.k * scale (+ bias[b|0, h|0, q, k], fp32), masked with the finite
// NEG_INF = -1e9 where the key is not visible: causal keeps k <= q + off with
// the bottom-right offset off = Tk - Tq, a sliding window keeps
// k > q + off - window, segment ids keep equal ids. The forward returns the
// output and the fp32 logsumexp lse [B, H, Tq]; the backward takes dO, lse
// and delta = rowsum(dO * O) [B, H, Tq] and returns dq, and dk/dv summed over
// the query heads of each kv group in fp32 (the TPU wrapper sums the
// per-head results afterwards). The bias gets no gradient.
//
// Rounding points are the TPU kernels': products of the input dtype
// accumulate in fp32; the forward rounds p = exp(s - m) to v's dtype before
// PV while l sums the unrounded p, with m the running maximum over the key
// tiles seen so far (the tile width per dtype and head width is
// fwd_block_k below, mirrored by FWD_BLOCK_K in ops/flash_attention.py); a
// tile whose keys are all masked gives p = 1 (exp(NEG_INF - NEG_INF)) until
// a live key wipes it with alpha = 0; the output divides by l_safe (1 where
// l == 0) and lse = m + log(max(l, 1e-30)). dq rounds ds = p (dp - delta)
// scale to k's dtype before ds.K; dk/dv keep p and ds in fp32: the SIMT
// kernel multiplies them in fp32, the tensor-core kernel splits each into
// hi = round(x) and lo = round(x - hi) in the input dtype and multiplies
// both (flash_dkv_wgmma), so neither is ever rounded once. Keys past Tk
// and queries past Tq do not exist (p = 0): the kernels mask the ragged edge
// themselves, so no length has to be padded to a multiple of a tile.
//
// Rows with no visible key at all (causal with Tq > Tk, or a query whose
// segment has no key in its window): like the TPU kernel, which skips whole
// tiles, such a row holds the mean of V over the key tiles its query tile
// visits (every entry is NEG_INF, so p = 1 for each), and no tile at all
// gives 0 with lse = NEG_INF + log(1e-30). Tiles here are 64-128 keys, not
// the TPU's 128-512, so these rows differ from the TPU kernel's and from the
// dense plain version's; parity tests compare live rows only.
//
// What bounds it on the H100: at the training shape (B=4, T=2048, 32 heads
// of 128, causal) attention does 4 * Dh flops per visible (query, key) pair
// in the forward, 6 * Dh in dq and 8 * Dh in dk/dv over ~2 MB of q/k/v per
// head: hundreds of flops per byte, so all three are bound by operations
// (989 TFLOP/s bf16 on the tensor cores).
//
// Two routes, chosen by dtype and head width (tensor_core_route, exported
// as ds_flash_route; ds_flash_kernel_launches counts what each call
// launched):
//
// bf16 / fp16: tensor-core kernels (flash_fwd_wgmma, flash_dq_wgmma,
// flash_dkv_wgmma; dk/dv up to head width 128).
// Forward and dq: a thread block owns one query tile of one head: 128 rows
// as two consumer warpgroups of 64 (64 rows, one warpgroup, at head width
// 256, where the accumulators need the registers), plus one producer warp.
//   - The producer's lane 0 loads the Q tile (dq: Q and dO) once and keeps
//     K and V tiles in flight through a 2-stage ring in shared memory with
//     TMA (cp.async.bulk.tensor, 128-byte swizzle, out-of-range rows and
//     columns read as zeros) and full / empty mbarriers.
//   - The consumers compute S = Q.K^T (dq also dP = dO.V^T) with wgmma
//     m64n64k16 from shared memory, fp32 accumulators in registers.
//   - Mask, online softmax (forward) or p and ds (dq) run in registers in
//     the accumulator layout: a thread holds 2 rows, and row max / sum are
//     two shuffles within a quad. alpha = exp(m_prev - m_cur) rescales the
//     output every tile, exactly as the TPU kernel does.
//   - p (forward) or ds (dq) is rounded to the input dtype in registers and
//     is wgmma's register A operand for P.V or dS.K; V and K are the same
//     staged tiles read as MN-major B operands (transpose bit), so one copy
//     of K serves both of dq's products.
//   - Causal and window bounds skip whole key tiles; tiles inside the band
//     with no bias, segments or ragged edge skip the per-element mask.
//   - Query tiles are scheduled longest first (causal rows near the end see
//     the most keys).
// dk/dv: a thread block owns 128 keys of one kv head (two consumer
// warpgroups of 64) and keeps their K and V tiles resident; Q, dO, lse and
// delta of every query tile that can see them, of every query head of the
// kv group, stream through a 3-stage ring (2 at width 256). It computes
// s^T = K.Q^T and dp^T = V.dO^T, keys as rows, so that p^T and ds^T leave the
// accumulators in the layout of wgmma's register A operand; dV += p^T.dO and
// dK += ds^T.Q take p and ds as hi + lo, two 16-bit products each, exact in
// fp32 (the split carries x to about 2^-16 |x| in bf16, 2^-22 |x| in fp16;
// fp16 ds is split times a power of two per key row, 2^10 unless a larger
// ds needs less, undone exactly before dK's rounding, so that it stays in
// fp16's normal range at the size of unscaled gradients and under its
// largest value at loss-scaled ones: kDsExp0).
// The split costs 12 Dh operations per visible pair against the function's
// 8 Dh. At head width 256 dK and dV alone would need 256 fp32 registers a
// thread, so that width keeps the SIMT kernel (the route says so).
// Head widths up to 256 are staged as 64, 128 or 256 columns (TMA reads the
// missing columns as zeros). TMA needs a 16-byte aligned base and 16-byte
// multiples for the strides; the Python wrapper copies inputs that break
// that into aligned tensors first.
//
// fp32, and dk/dv at head width 256: the SIMT kernels below
// (flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel), fp32 FMAs on the
// CUDA cores (67 TFLOP/s peak). wgmma has no exact fp32 product (TF32 is
// not the TPU kernel's arithmetic).
//   - A thread block of 256 threads (a 16 x 16 grid) owns one q tile of one
//     head of one batch row (forward, dq) or one k tile of one kv head
//     (dk/dv) and loops over the tiles it can see itself; tiles outside the
//     causal / window band are never loaded;
//   - tiles are staged in shared memory as fp32 rows padded by 4 floats, read
//     through [B, T, H, Dh] strides with no transposed copy; each thread
//     computes a 4 x 4 (or 2 x 4, 2 x 2) block of the score tile with float4
//     shared loads, rows ty + 16 i and columns tx + 16 j, so a row's 16
//     threads are 16 lanes of one warp and row max / sum are shuffles;
//   - the output accumulators live in registers, columns tx * 4 + 64 c.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

// Mirrored field by field by _FlashParams in ops/flash_attention.py.
struct DsFlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;                 // [B|1, H|1, Tq, Tk] fp32, last two dims contiguous
  const int* qseg;                   // [B, Tq] int32, or null
  const int* kseg;                   // [B, Tk] int32
  const float* lse;                  // [B, H, Tq] (backward input)
  const float* delta;                // [B, H, Tq] (backward input)
  void* out;                         // [B, Tq, H, Dh] contiguous
  float* lse_out;                    // [B, H, Tq]
  void* dq;                          // [B, Tq, H, Dh] contiguous
  void* dk;                          // [B, Tk, KV, Dh] contiguous
  void* dv;                          // [B, Tk, KV, Dh] contiguous
  long long q_sb, q_st, q_sh;        // element strides of q over (B, T, H)
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  long long bias_sb, bias_sh;        // 0 where the bias broadcasts
  int B, Tq, Tk, H, KV, dh, causal, window;
  float scale;
};

namespace {

using Params = DsFlashParams;

constexpr int kThreads = 256;        // a 16 x 16 thread grid
constexpr int kPad = 4;              // floats of padding after each smem row
constexpr float kNegInf = -1e9f;     // the TPU kernels' finite mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the TPU kernels' .astype(dtype) on fp32
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

// Rows [r0, r0 + R) of one head of a [.., T, .., Dh] tensor (src points at
// row 0 of that head, rows s_t elements apart) into smem [R][D + kPad] as
// fp32; rows >= n_rows and columns >= dh are zero.
template <typename T, int R, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long s_t,
                                          int r0, int n_rows, int dh) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r0 + r < n_rows && d < dh) x = to_float(src[static_cast<long long>(r0 + r) * s_t + d]);
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

// The masked, scaled, biased logit of (query qi, key kj) from the raw q.k
// product s: -inf where either index is outside its tensor (p = 0 there),
// NEG_INF where the key is not visible.
__device__ __forceinline__ float logit(const Params& p, float s, int b, int h, int qi, int kj) {
  if (qi >= p.Tq || kj >= p.Tk) return -INFINITY;
  float x = s * p.scale;
  if (p.bias != nullptr)
    x += p.bias[b * p.bias_sb + h * p.bias_sh + static_cast<long long>(qi) * p.Tk + kj];
  const int off = p.Tk - p.Tq;
  bool visible = true;
  if (p.causal) visible = kj <= qi + off;
  if (p.window > 0) visible = visible && kj > qi + off - p.window;
  if (p.qseg != nullptr)
    visible = visible && p.qseg[static_cast<long long>(b) * p.Tq + qi] ==
                             p.kseg[static_cast<long long>(b) * p.Tk + kj];
  return visible ? x : kNegInf;
}

// Inclusive key range any query in [q_first, q_last] can see; empty when hi < lo.
__device__ __forceinline__ void key_range(const Params& p, int q_first, int q_last, int& lo,
                                          int& hi) {
  const int off = p.Tk - p.Tq;
  lo = 0;
  hi = p.Tk - 1;
  if (p.causal) hi = min(hi, q_last + off);
  if (p.window > 0) lo = max(lo, q_first + off - p.window + 1);
}

// Inclusive query range that can see any key in [k_first, k_last].
__device__ __forceinline__ void query_range(const Params& p, int k_first, int k_last, int& lo,
                                            int& hi) {
  const int off = p.Tk - p.Tq;
  lo = 0;
  hi = p.Tq - 1;
  if (p.causal) lo = max(lo, k_first - off);
  if (p.window > 0) hi = min(hi, k_last + p.window - 1 - off);
}

// ---------------------------------------------------------------------------
// forward: grid (q tiles, H, B)
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
constexpr int fwd_smem_floats() { return (BQ + BK) * (D + kPad) + BQ * (BK + kPad); }

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int RI = BQ / 16, CJ = BK / 16, NC = D / 16, LDP = BK + kPad;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [BQ][D + kPad]
  float* sX = sQ + BQ * (D + kPad);              // [BK][D + kPad]: K, then V
  float* sP = sX + BK * (D + kPad);              // [BQ][BK + kPad]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kvh = h / (p.H / p.KV);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile<T, BQ, D>(sQ, q, p.q_st, q0, p.Tq, p.dh);

  int k_lo, k_hi;
  key_range(p, q0, min(q0 + BQ, p.Tq) - 1, k_lo, k_hi);
  const int kt_lo = k_lo / BK, kt_hi = k_hi >= k_lo ? k_hi / BK : kt_lo - 1;

  float m[RI], l[RI], o[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers of sX and sP are done
    load_tile<T, BK, D>(sX, k, p.k_st, k0, p.Tk, p.dh);
    __syncthreads();
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    product_nt<RI, CJ, D>(s, sQ, sX, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = logit(p, s[i][j], b, h, qi, k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float pj = expf(s[i][j] - m_new);
        sum += pj;
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = round_to<T>(pj);   // p.astype(v.dtype)
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();   // everyone is done with K
    load_tile<T, BK, D>(sX, v, p.v_st, k0, p.Tk, p.dh);
    __syncthreads();
    product_nn<RI, BK, D>(o, sP, sX, ty, tx);
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Tq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* dst = out + ((static_cast<long long>(b) * p.Tq + qi) * p.H + h) * p.dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx * 4 + 64 * (c / 4) + c % 4;
      if (d < p.dh) dst[d] = from_float<T>(o[i][c] / l_safe);
    }
    if (tx == 0)
      p.lse_out[(static_cast<long long>(b) * p.H + h) * p.Tq + qi] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// dq: grid (q tiles, H, B)
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
constexpr int dq_smem_floats() { return (2 * BQ + BK) * (D + kPad) + BQ * (BK + kPad); }

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  constexpr int RI = BQ / 16, CJ = BK / 16, NC = D / 16, LDP = BK + kPad;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [BQ][D + kPad]
  float* sO = sQ + BQ * (D + kPad);              // dO [BQ][D + kPad]
  float* sX = sO + BQ * (D + kPad);              // [BK][D + kPad]: V, then K
  float* sS = sX + BK * (D + kPad);              // ds [BQ][BK + kPad]

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kvh = h / (p.H / p.KV);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile<T, BQ, D>(sQ, q, p.q_st, q0, p.Tq, p.dh);
  load_tile<T, BQ, D>(sO, dout, p.do_st, q0, p.Tq, p.dh);

  float lse[RI], delta[RI], dq[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    const long long row = (static_cast<long long>(b) * p.H + h) * p.Tq + qi;
    lse[i] = qi < p.Tq ? p.lse[row] : 0.f;
    delta[i] = qi < p.Tq ? p.delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;
  }

  int k_lo, k_hi;
  key_range(p, q0, min(q0 + BQ, p.Tq) - 1, k_lo, k_hi);
  const int kt_lo = k_lo / BK, kt_hi = k_hi >= k_lo ? k_hi / BK : kt_lo - 1;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, BK, D>(sX, v, p.v_st, k0, p.Tk, p.dh);
    __syncthreads();
    float dp[RI][CJ], s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) dp[i][j] = s[i][j] = 0.f;
    product_nt<RI, CJ, D>(dp, sO, sX, ty, tx);   // dp = dO . V^T in fp32
    __syncthreads();
    load_tile<T, BK, D>(sX, k, p.k_st, k0, p.Tk, p.dh);
    __syncthreads();
    product_nt<RI, CJ, D>(s, sQ, sX, ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float x = logit(p, s[i][j], b, h, qi, k0 + tx + 16 * j);
        const float pj = expf(x - lse[i]);
        // ds.astype(k.dtype) before ds . K
        sS[(ty + 16 * i) * LDP + tx + 16 * j] = round_to<T>(pj * (dp[i][j] - delta[i]) * p.scale);
      }
    }
    __syncthreads();
    product_nn<RI, BK, D>(dq, sS, sX, ty, tx);
  }

  T* out = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Tq) continue;
    T* dst = out + ((static_cast<long long>(b) * p.Tq + qi) * p.H + h) * p.dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx * 4 + 64 * (c / 4) + c % 4;
      if (d < p.dh) dst[d] = from_float<T>(dq[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv: grid (k tiles, KV, B); loops over the kv group's query heads
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
constexpr int dkv_smem_floats() { return 2 * (BK + BQ) * (D + kPad) + BK * (BQ + kPad); }

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Params p) {
  constexpr int RI = BK / 16, CJ = BQ / 16, NC = D / 16, LDP = BQ + kPad;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // [BK][D + kPad]
  float* sV = sK + BK * (D + kPad);              // [BK][D + kPad]
  float* sQ = sV + BK * (D + kPad);              // [BQ][D + kPad]
  float* sO = sQ + BQ * (D + kPad);              // dO [BQ][D + kPad]
  float* sP = sO + BQ * (D + kPad);              // p^T, then ds^T [BK][BQ + kPad]

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int rep = p.H / p.KV;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile<T, BK, D>(sK, k, p.k_st, k0, p.Tk, p.dh);
  load_tile<T, BK, D>(sV, v, p.v_st, k0, p.Tk, p.dh);

  float dk[RI][NC], dv[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  int q_lo, q_hi;
  query_range(p, k0, min(k0 + BK, p.Tk) - 1, q_lo, q_hi);
  const int qt_lo = q_lo / BQ, qt_hi = q_hi >= q_lo ? q_hi / BQ : qt_lo - 1;

  for (int h = kvh * rep; h < (kvh + 1) * rep; ++h) {
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous tile's readers of sQ, sO and sP are done
      load_tile<T, BQ, D>(sQ, q, p.q_st, q0, p.Tq, p.dh);
      load_tile<T, BQ, D>(sO, dout, p.do_st, q0, p.Tq, p.dh);
      float lse[CJ], delta[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int qi = q0 + tx + 16 * j;
        const long long row = (static_cast<long long>(b) * p.H + h) * p.Tq + qi;
        lse[j] = qi < p.Tq ? p.lse[row] : 0.f;
        delta[j] = qi < p.Tq ? p.delta[row] : 0.f;
      }
      __syncthreads();
      float s[RI][CJ], dpt[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dpt[i][j] = 0.f;
      product_nt<RI, CJ, D>(s, sK, sQ, ty, tx);   // s^T = K . Q^T
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int kj = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = expf(logit(p, s[i][j], b, h, q0 + tx + 16 * j, kj) - lse[j]);   // p^T, fp32
          sP[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
        }
      }
      __syncthreads();
      product_nn<RI, BQ, D>(dv, sP, sO, ty, tx);     // dV += p^T . dO
      product_nt<RI, CJ, D>(dpt, sV, sO, ty, tx);    // dp^T = V . dO^T
      __syncthreads();                               // everyone is done reading p^T
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j)
          sP[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j] * (dpt[i][j] - delta[j]) * p.scale;
      __syncthreads();
      product_nn<RI, BQ, D>(dk, sP, sQ, ty, tx);     // dK += ds^T . Q
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= p.Tk) continue;
    const long long row = ((static_cast<long long>(b) * p.Tk + kj) * p.KV + kvh) * p.dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx * 4 + 64 * (c / 4) + c % 4;
      if (d < p.dh) {
        dk_out[row + d] = from_float<T>(dk[i][c]);
        dv_out[row + d] = from_float<T>(dv[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor-core forward and dq (wgmma fed by a TMA ring)
// ---------------------------------------------------------------------------

// Keys per tile of the forward kernels, by dtype code (0 fp32, 1 fp16,
// 2 bf16) and staged head width: the width against whose running maximum p
// is rounded. FWD_BLOCK_K of ops/flash_attention.py mirrors it.
constexpr int fwd_block_k(int dtype, int staged_dh) {
  return dtype == 0 ? 64 : staged_dh == 256 ? 64 : 128;
}

constexpr int kStages = 2;          // K / V ring depth
constexpr int kBlockBytes = 128;    // bytes per row of a 64-column block

// Shared memory: `resident` query-side tiles of BQ rows (Q; dq adds dO),
// then kStages stages of K and V, each DS / 64 column blocks, then the
// barriers; +1024 for aligning the base.
template <int DS, int BQ, int BK>
constexpr int tc_smem_bytes(int resident) {
  return 1024 + resident * BQ * DS * 2 + kStages * 2 * BK * DS * 2 + 8 * (1 + 2 * kStages);
}

// Threads of a tensor-core block: NC consumer warpgroups, then the
// producer. With two consumers the producer is a whole warpgroup, so that
// setmaxnreg can move its registers to the consumers (24 + 2 x 240 per
// thread slot: each SM sub-partition holds one warp of each warpgroup; at
// the even split, 168 registers a thread, the forward spilled 300 bytes at
// head width 128, at 240 it spills 100); with one consumer a single producer
// warp leaves the consumer 255 registers as is.
constexpr int tc_threads(int nc) { return nc == 2 ? 3 * 128 : 128 + 32; }
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Ring and barriers shared by the two kernels. The producer warp is warp
// NC * 4 (after the consumer warpgroups); only its lane 0 works.
struct Ring {
  uint8_t* resident;   // query-side tiles: `resident` x DS / 64 blocks of [BQ][64]
  uint8_t* stages;     // per stage: DS / 64 blocks of K [BK][64], then of V
  uint64_t* q_full;    // the resident tiles have landed
  uint64_t* full;      // [kStages]: stage filled
  uint64_t* empty;     // [kStages]: stage released by every consumer thread
};

template <int DS, int BQ, int BK>
__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw, int resident) {
  Ring r;
  r.resident = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
  r.stages = r.resident + resident * BQ * DS * 2;
  r.q_full = reinterpret_cast<uint64_t*>(r.stages + kStages * 2 * BK * DS * 2);
  r.full = r.q_full + 1;
  r.empty = r.full + kStages;
  return r;
}

// The producer: resident tiles once, then K and V of n_tiles key tiles from
// kt_lo on, each stage reused once every consumer thread has released it.
template <int DS, int BQ, int BK>
__device__ __forceinline__ void produce(const Ring& r, const CUtensorMap* const* res_maps,
                                        int resident, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int q0, int h, int kvh, int b,
                                        int kt_lo, int n_tiles) {
  constexpr int NDC = DS / 64;
  constexpr uint32_t kQBlock = BQ * kBlockBytes, kKBlock = BK * kBlockBytes;
  constexpr uint32_t kStageBytes = 2 * NDC * kKBlock;
  hopper::mbar_arrive_expect_tx(r.q_full, resident * NDC * kQBlock);
  for (int t = 0; t < resident; ++t)
#pragma unroll
    for (int c = 0; c < NDC; ++c)
      hopper::tma_load_4d(r.resident + (t * NDC + c) * kQBlock, res_maps[t], r.q_full, 64 * c, q0,
                          h, b);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    if (i >= kStages) hopper::mbar_wait(&r.empty[s], (i / kStages - 1) & 1);
    const int k0 = (kt_lo + i) * BK;
    uint8_t* st = r.stages + s * kStageBytes;
    hopper::mbar_arrive_expect_tx(&r.full[s], kStageBytes);
#pragma unroll
    for (int c = 0; c < NDC; ++c) {
      hopper::tma_load_4d(st + c * kKBlock, tk, &r.full[s], 64 * c, k0, kvh, b);
      hopper::tma_load_4d(st + (NDC + c) * kKBlock, tv, &r.full[s], 64 * c, k0, kvh, b);
    }
  }
}

// S[n] = A . K^T for the NS = BK / 64 key chunks of a staged tile, A the
// warpgroup's 64 resident rows at shared address a_rows (column blocks
// BQ * 128 bytes apart), K at k_tile (column blocks BK * 128 bytes apart).
template <typename T, int DS, int BQ, int BK>
__device__ __forceinline__ void issue_qk(float (&acc)[BK / 64][32], uint32_t a_rows,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DS / 16; ++kk) {
    const uint64_t da = hopper::desc_sw128(a_rows + (kk / 4) * BQ * kBlockBytes + (kk % 4) * 32);
#pragma unroll
    for (int n = 0; n < BK / 64; ++n)
      hopper::wgmma_ss<T>(acc[n],
                          da,
                          hopper::desc_sw128(k_tile + (kk / 4) * BK * kBlockBytes +
                                             n * 64 * kBlockBytes + (kk % 4) * 32),
                          kk > 0);
  }
}

// acc[c] += A . X for the DS / 64 column blocks of a staged [BK][DS] tile X
// (V in the forward, K in dq) read MN-major; A is a[BK / 16] register
// fragments (P or dS in the input dtype).
template <typename T, int DS, int BK>
__device__ __forceinline__ void issue_px(float (&acc)[DS / 64][32], const uint32_t (&a)[BK / 16][4],
                                         uint32_t x_tile) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < DS / 64; ++c)
      hopper::wgmma_rs_mn<T>(acc[c], a[kk],
                             hopper::desc_sw128(x_tile + c * BK * kBlockBytes + kk * 16 * kBlockBytes));
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N][32]) {
#pragma unroll
  for (int i = 0; i < N; ++i) hopper::fence_regs(r[i]);
}

// Rounds the accumulator-layout values x[BK / 64][32] to T and packs them as
// the register A fragments of the BK / 16 k-steps of the next product.
template <typename T, int BK>
__device__ __forceinline__ void to_fragments(const float (&x)[BK / 64][32],
                                             uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const int n = kk / 4, j = 8 * (kk % 4);   // 4 j: the first of two n8 blocks
    a[kk][0] = hopper::pack2<T>(x[n][j + 0], x[n][j + 1]);
    a[kk][1] = hopper::pack2<T>(x[n][j + 2], x[n][j + 3]);
    a[kk][2] = hopper::pack2<T>(x[n][j + 4], x[n][j + 5]);
    a[kk][3] = hopper::pack2<T>(x[n][j + 6], x[n][j + 7]);
  }
}

// The logits of one staged tile in place: scaled, biased and masked (see
// logit) unless the whole tile is inside the visible band of all 64 rows
// [r_first, r_first + 64) with no bias, segments or ragged edge. Element
// (n, 4 j + e) of this thread is row qi[e / 2], key k0 + 64 n + 8 j + 2 (lane
// % 4) + e % 2.
template <int BK>
__device__ __forceinline__ void mask_tile(const Params& p, float (&x)[BK / 64][32], int b, int h,
                                          const int (&qi)[2], int r_first, int k0, int lane) {
  const int off = p.Tk - p.Tq, r_last = r_first + 63;
  const bool interior = k0 + BK <= p.Tk && r_last < p.Tq && p.bias == nullptr &&
                        p.qseg == nullptr && (!p.causal || k0 + BK - 1 <= r_first + off) &&
                        (p.window <= 0 || k0 > r_last + off - p.window);
  if (interior) {
#pragma unroll
    for (int n = 0; n < BK / 64; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) x[n][i] *= p.scale;
    return;
  }
#pragma unroll
  for (int n = 0; n < BK / 64; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      x[n][i] = logit(p, x[n][i], b, h, qi[(i % 4) / 2], k0 + 64 * n + 8 * (i / 4) + 2 * (lane % 4) + i % 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Forward. Grid (q tiles, H, B); NC consumer warpgroups of 64 rows and one
// producer warp; key tiles of BK.
template <typename T, int DS, int NC, int BK>
__global__ void __launch_bounds__(tc_threads(NC), 1)
    flash_fwd_wgmma(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  constexpr int BQ = NC * 64, NDC = DS / 64, NS = BK / 64;
  constexpr uint32_t kStageBytes = 2 * NDC * BK * kBlockBytes;
  extern __shared__ uint8_t smem_raw[];
  const Ring r = make_ring<DS, BQ, BK>(smem_raw, 1);

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest causal rows first
  const int kvh = h / (p.H / p.KV);
  int k_lo, k_hi;
  key_range(p, q0, min(q0 + BQ, p.Tq) - 1, k_lo, k_hi);
  const int kt_lo = k_lo / BK;
  const int n_tiles = k_hi >= k_lo ? k_hi / BK - kt_lo + 1 : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(r.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&r.full[s], 1);
      hopper::mbar_init(&r.empty[s], NC * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NC * 4) {
    if constexpr (NC == 2) hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp == NC * 4 && lane == 0) {
      const CUtensorMap* res[1] = {&tq};
      produce<DS, BQ, BK>(r, res, 1, &tk, &tv, q0, h, kvh, b, kt_lo, n_tiles);
    }
    return;
  }
  if constexpr (NC == 2) hopper::setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4;
  const int r_first = q0 + 64 * wg;
  const int qi[2] = {r_first + 16 * (warp % 4) + lane / 4, r_first + 16 * (warp % 4) + lane / 4 + 8};
  const uint32_t q_rows = hopper::smem_u32(r.resident) + 64 * wg * kBlockBytes;

  float o[NDC][32];
#pragma unroll
  for (int c = 0; c < NDC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  hopper::mbar_wait(r.q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = (kt_lo + it) * BK;
    const uint32_t k_tile = hopper::smem_u32(r.stages) + s * kStageBytes;
    const uint32_t v_tile = k_tile + NDC * BK * kBlockBytes;
    hopper::mbar_wait(&r.full[s], (it / kStages) & 1);

    float x[NS][32];
    __syncwarp();
    fence_all(x);
    hopper::wgmma_fence();
    issue_qk<T, DS, BQ, BK>(x, q_rows, k_tile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_all(x);

    mask_tile<BK>(p, x, b, h, qi, r_first, k0, lane);
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

    uint32_t pa[BK / 16][4];   // p.astype(v.dtype)
    to_fragments<T, BK>(x, pa);
    __syncwarp();
    fence_all(o);
    hopper::wgmma_fence();
    issue_px<T, DS, BK>(o, pa, v_tile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_all(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hopper::fence_regs(pa[kk]);
    hopper::mbar_arrive(&r.empty[s]);
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (qi[e] >= p.Tq) continue;
    const float l_safe = l[e] == 0.f ? 1.f : l[e];
    T* dst = out + ((static_cast<long long>(b) * p.Tq + qi[e]) * p.H + h) * p.dh;
#pragma unroll
    for (int c = 0; c < NDC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int d = 64 * c + 8 * j + 2 * (lane % 4) + u;
          if (d < p.dh) dst[d] = from_float<T>(o[c][4 * j + 2 * e + u] / l_safe);
        }
    if (lane % 4 == 0)
      p.lse_out[(static_cast<long long>(b) * p.H + h) * p.Tq + qi[e]] =
          m[e] + logf(fmaxf(l[e], 1e-30f));
  }
}

// dq. Grid (q tiles, H, B); Q and dO resident, K and V streamed.
template <typename T, int DS, int NC, int BK>
__global__ void __launch_bounds__(tc_threads(NC), 1)
    flash_dq_wgmma(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv) {
  constexpr int BQ = NC * 64, NDC = DS / 64, NS = BK / 64;
  constexpr uint32_t kStageBytes = 2 * NDC * BK * kBlockBytes;
  extern __shared__ uint8_t smem_raw[];
  const Ring r = make_ring<DS, BQ, BK>(smem_raw, 2);

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int kvh = h / (p.H / p.KV);
  int k_lo, k_hi;
  key_range(p, q0, min(q0 + BQ, p.Tq) - 1, k_lo, k_hi);
  const int kt_lo = k_lo / BK;
  const int n_tiles = k_hi >= k_lo ? k_hi / BK - kt_lo + 1 : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(r.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&r.full[s], 1);
      hopper::mbar_init(&r.empty[s], NC * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NC * 4) {
    if constexpr (NC == 2) hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp == NC * 4 && lane == 0) {
      const CUtensorMap* res[2] = {&tq, &tdo};
      produce<DS, BQ, BK>(r, res, 2, &tk, &tv, q0, h, kvh, b, kt_lo, n_tiles);
    }
    return;
  }
  if constexpr (NC == 2) hopper::setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4;
  const int r_first = q0 + 64 * wg;
  const int qi[2] = {r_first + 16 * (warp % 4) + lane / 4, r_first + 16 * (warp % 4) + lane / 4 + 8};
  const uint32_t q_rows = hopper::smem_u32(r.resident) + 64 * wg * kBlockBytes;
  const uint32_t do_rows = q_rows + NDC * BQ * kBlockBytes;
  float lse[2], delta[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const long long row = (static_cast<long long>(b) * p.H + h) * p.Tq + qi[e];
    lse[e] = qi[e] < p.Tq ? p.lse[row] : 0.f;
    delta[e] = qi[e] < p.Tq ? p.delta[row] : 0.f;
  }

  float dq[NDC][32];
#pragma unroll
  for (int c = 0; c < NDC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

  hopper::mbar_wait(r.q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = (kt_lo + it) * BK;
    const uint32_t k_tile = hopper::smem_u32(r.stages) + s * kStageBytes;
    const uint32_t v_tile = k_tile + NDC * BK * kBlockBytes;
    hopper::mbar_wait(&r.full[s], (it / kStages) & 1);

    float x[NS][32], dp[NS][32];
    __syncwarp();
    fence_all(x);
    fence_all(dp);
    hopper::wgmma_fence();
    issue_qk<T, DS, BQ, BK>(x, q_rows, k_tile);     // s = Q.K^T
    issue_qk<T, DS, BQ, BK>(dp, do_rows, v_tile);   // dp = dO.V^T, exact products in fp32
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_all(x);
    fence_all(dp);

    mask_tile<BK>(p, x, b, h, qi, r_first, k0, lane);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = (i % 4) / 2;
        x[n][i] = expf(x[n][i] - lse[e]) * (dp[n][i] - delta[e]) * p.scale;
      }
    uint32_t da[BK / 16][4];   // ds.astype(k.dtype)
    to_fragments<T, BK>(x, da);
    __syncwarp();
    fence_all(dq);
    hopper::wgmma_fence();
    issue_px<T, DS, BK>(dq, da, k_tile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_all(dq);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hopper::fence_regs(da[kk]);
    hopper::mbar_arrive(&r.empty[s]);
  }

  T* out = static_cast<T*>(p.dq);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (qi[e] >= p.Tq) continue;
    T* dst = out + ((static_cast<long long>(b) * p.Tq + qi[e]) * p.H + h) * p.dh;
#pragma unroll
    for (int c = 0; c < NDC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int d = 64 * c + 8 * j + 2 * (lane % 4) + u;
          if (d < p.dh) dst[d] = from_float<T>(dq[c][4 * j + 2 * e + u]);
        }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16 dk/dv: split products on wgmma
// ---------------------------------------------------------------------------

// x split into hi = round(x) and lo = round(x - hi), both in T, packed in
// pairs like pack2: hi + lo carries x to about 2^-16 |x| (bf16) or 2^-22 |x|
// (fp16, down to an absolute 2^-25 where lo is subnormal), and each product
// of a 16-bit hi or lo with a 16-bit operand is exact in fp32.
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = hopper::pack2<T>(x0, x1);
  float2 h;
  if constexpr (std::is_same<T, __half>::value)
    h = __half22float2(*reinterpret_cast<const __half2*>(&hi));
  else
    h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = hopper::pack2<T>(x0 - h.x, x1 - h.y);
}

// fp16 ds is split as ds * 2^e, with one exponent e per dK accumulator row
// (key), and each row of dK is scaled back by 2^-e before the one rounding
// (all exact: powers of two). fp16's 5-bit exponent puts ds under 6.1e-5
// (its smallest normal) once dO is the size of an unscaled gradient (1e-3:
// ds about 1e-6), where hi is subnormal and lo carries nothing: the
// absolute 2^-25 residual is then a few percent of ds. So e starts at
// kDsExp0 = 10, which splits ds from about 1e-7 up with both parts normal or
// lo's residual far under the output's rounding. A fixed 2^10 would send hi
// to inf at |ds| >= 64, which a loss-scaled gradient reaches (dO about 65
// at the default scale 2^16) where the TPU kernel's fp32 ds stays finite.
// So when a query tile's max |ds| in a row, times 2^e, would reach 2^15
// (ds_exp_limit), the row's e drops to the largest exponent that keeps it
// under, and the row's fp32 accumulators are multiplied by the exact power
// of two, as the online softmax rescales by alpha. e only falls, so every
// earlier product stays exact. bf16 has fp32's exponent range and is split
// as is. tests/flash_rounding.py dkv_split_product mirrors this rule.
constexpr int kDsExp0 = 10;

// 2^e for -126 <= e <= 127, exactly.
__device__ __forceinline__ float exp2_int(int e) { return __int_as_float((e + 127) << 23); }

// The largest e with m * 2^e < 2^15 for m >= 0 (m * 2^(14 - floor(log2 m))
// lies in [2^14, 2^15)), at least -100; m = 0 or subnormal gives over
// kDsExp0, so the row keeps its exponent.
__device__ __forceinline__ int ds_exp_limit(float m) {
  const int log2m = static_cast<int>((__float_as_uint(m) >> 23) & 0xff) - 127;
  return max(14 - log2m, -100);
}

// to_fragments with the split: the hi and lo register A fragments of the
// accumulator-layout values x[BQ / 64][32].
template <typename T, int BQ>
__device__ __forceinline__ void to_split_fragments(const float (&x)[BQ / 64][32],
                                                   uint32_t (&hi)[BQ / 16][4],
                                                   uint32_t (&lo)[BQ / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    const int n = kk / 4, j = 8 * (kk % 4);
#pragma unroll
    for (int r = 0; r < 4; ++r) split2<T>(x[n][j + 2 * r], x[n][j + 2 * r + 1], hi[kk][r], lo[kk][r]);
  }
}

// The transposed logits s^T of one staged tile in place: rows are the 64
// keys [k_first, k_first + 64) of the warpgroup, columns the BQ queries from
// q0. Element (n, 4 j + e) of this thread is key kj[e / 2], query q0 + 64 n
// + 8 j + 2 (lane % 4) + e % 2. Interior tiles (every key visible to every
// query, no bias, segments or ragged edge) are only scaled.
template <int BQ>
__device__ __forceinline__ void mask_tile_t(const Params& p, float (&x)[BQ / 64][32], int b, int h,
                                            const int (&kj)[2], int k_first, int q0, int lane) {
  const int off = p.Tk - p.Tq, k_last = k_first + 63, q_last = q0 + BQ - 1;
  const bool interior = k_last < p.Tk && q_last < p.Tq && p.bias == nullptr &&
                        p.qseg == nullptr && (!p.causal || k_last <= q0 + off) &&
                        (p.window <= 0 || k_first > q_last + off - p.window);
  if (interior) {
#pragma unroll
    for (int n = 0; n < BQ / 64; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) x[n][i] *= p.scale;
    return;
  }
#pragma unroll
  for (int n = 0; n < BQ / 64; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      x[n][i] = logit(p, x[n][i], b, h, q0 + 64 * n + 8 * (i / 4) + 2 * (lane % 4) + i % 2,
                      kj[(i % 4) / 2]);
}

// Ring depth of the dk/dv kernel: three stages of Q, dO, lse and delta where
// they fit beside the resident K and V tiles.
template <int DS>
__host__ __device__ constexpr int dkv_stages() { return DS <= 128 ? 3 : 2; }

// Shared memory of the dk/dv kernel: K and V of BKV rows (resident), then
// per stage Q and dO of BQ rows and 1024 bytes holding the BQ lse and delta
// values (BQ <= 128; every stage stays 1024-byte aligned for the swizzled
// TMA writes), then the barriers (kv_full, full[S], empty[S]); +1024 for
// aligning the base.
template <int DS, int BKV, int BQ>
constexpr int dkv_tc_smem_bytes() {
  return 1024 + 2 * BKV * DS * 2 + dkv_stages<DS>() * (2 * BQ * DS * 2 + 1024) +
         8 * (1 + 2 * dkv_stages<DS>());
}

// dk/dv. Grid (key tiles of NC x 64 keys, KV, B); NC consumer warpgroups of
// 64 keys each and one producer warp. K and V of the block's keys are loaded
// once and stay; Q and dO of every query tile that can see them (of every
// query head of the kv group) stream through the ring, with lse and delta.
// Everything is computed transposed, keys as rows, so that p^T and ds^T leave
// the accumulators in the layout of wgmma's register A operand:
//   s^T = K.Q^T and dp^T = V.dO^T  (wgmma, both operands K-major in smem)
//   p^T = exp(s^T - lse), ds^T = p^T (dp^T - delta) scale  (fp32 registers)
//   dV += p_hi^T.dO + p_lo^T.dO, dK += ds_hi^T.Q + ds_lo^T.Q  (wgmma, A split
//   in registers, dO and Q read MN-major through the transpose bit)
// so p and ds are never rounded once to T: each product is exact in fp32 and
// the sums differ from the TPU kernel's fp32 products by the split's
// residual and the summation order. dK and dV sum over the group's query
// heads in fp32 and are rounded once in the epilogue.
template <typename T, int DS, int NC, int BQ>
__global__ void __launch_bounds__(tc_threads(NC), 1)
    flash_dkv_wgmma(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv) {
  constexpr int BKV = NC * 64, NDC = DS / 64, NQ = BQ / 64, S = dkv_stages<DS>();
  static_assert(NC == 2, "the producer is a whole warpgroup, for setmaxnreg");
  constexpr uint32_t kKvBlock = BKV * kBlockBytes, kQBlock = BQ * kBlockBytes;
  constexpr uint32_t kTileBytes = 2 * NDC * kQBlock;   // Q and dO of one stage
  constexpr uint32_t kStageBytes = kTileBytes + 1024;  // + lse and delta
  static_assert(2 * BQ * 4 <= 1024, "lse and delta of a query tile fill 1024 bytes");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* resident = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                 ~static_cast<uintptr_t>(1023));
  uint8_t* stages = resident + 2 * NDC * kKvBlock;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stages + S * kStageBytes);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BKV;
  const int rep = p.H / p.KV;
  int q_lo, q_hi;
  query_range(p, k0, min(k0 + BKV, p.Tk) - 1, q_lo, q_hi);
  const int qt_lo = q_lo / BQ;
  const int n_qt = q_hi >= q_lo ? q_hi / BQ - qt_lo + 1 : 0;
  const int n_items = rep * n_qt;   // (query head, query tile) pairs
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);   // the TMA bytes, and the producer warp's lanes
      hopper::mbar_init(&empty[s], NC * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NC * 4) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp != NC * 4) return;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kv_full, 2 * NDC * kKvBlock);
#pragma unroll
      for (int c = 0; c < NDC; ++c) {
        hopper::tma_load_4d(resident + c * kKvBlock, &tk, kv_full, 64 * c, k0, kvh, b);
        hopper::tma_load_4d(resident + (NDC + c) * kKvBlock, &tv, kv_full, 64 * c, k0, kvh, b);
      }
    }
    for (int i = 0; i < n_items; ++i) {
      const int s = i % S;
      if (i >= S) hopper::mbar_wait(&empty[s], (i / S - 1) & 1);
      const int h = kvh * rep + i / n_qt, q0 = (qt_lo + i % n_qt) * BQ;
      uint8_t* st = stages + s * kStageBytes;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[s], kTileBytes);
#pragma unroll
        for (int c = 0; c < NDC; ++c) {
          hopper::tma_load_4d(st + c * kQBlock, &tq, &full[s], 64 * c, q0, h, b);
          hopper::tma_load_4d(st + (NDC + c) * kQBlock, &tdo, &full[s], 64 * c, q0, h, b);
        }
      }
      float* rows = reinterpret_cast<float*>(st + kTileBytes);   // lse [BQ], delta [BQ]
      const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Tq;
      for (int j = lane; j < BQ; j += 32) {
        const bool live = q0 + j < p.Tq;
        rows[j] = live ? p.lse[row0 + q0 + j] : 0.f;
        rows[BQ + j] = live ? p.delta[row0 + q0 + j] : 0.f;
      }
      hopper::mbar_arrive(&full[s]);   // releases the lane's lse / delta stores
    }
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4;
  const int k_first = k0 + 64 * wg;
  const int kj[2] = {k_first + 16 * (warp % 4) + lane / 4, k_first + 16 * (warp % 4) + lane / 4 + 8};
  const uint32_t k_rows = hopper::smem_u32(resident) + 64 * wg * kBlockBytes;
  const uint32_t v_rows = k_rows + NDC * kKvBlock;

  float dk[NDC][32], dv[NDC][32];
#pragma unroll
  for (int c = 0; c < NDC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;
  constexpr bool kScaleDs = std::is_same<T, __half>::value;
  int ds_exp[2] = {kScaleDs ? kDsExp0 : 0, kScaleDs ? kDsExp0 : 0};   // rows kj[0], kj[1]

  hopper::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_items; ++it) {
    const int s = it % S;
    const int h = kvh * rep + it / n_qt, q0 = (qt_lo + it % n_qt) * BQ;
    const uint32_t q_tile = hopper::smem_u32(stages) + s * kStageBytes;
    const uint32_t do_tile = q_tile + NDC * kQBlock;
    const float* lse = reinterpret_cast<const float*>(stages + s * kStageBytes + kTileBytes);
    const float* delta = lse + BQ;
    hopper::mbar_wait(&full[s], (it / S) & 1);

    // s^T, then dp^T as a second group: the mask and exp of s^T overlap the
    // dp^T product
    float x[NQ][32], dp[NQ][32];
    __syncwarp();
    fence_all(x);
    fence_all(dp);
    hopper::wgmma_fence();
    issue_qk<T, DS, BKV, BQ>(x, k_rows, q_tile);     // s^T = K.Q^T
    hopper::wgmma_commit();
    issue_qk<T, DS, BKV, BQ>(dp, v_rows, do_tile);   // dp^T = V.dO^T, exact products in fp32
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    fence_all(x);

    mask_tile_t<BQ>(p, x, b, h, kj, k_first, q0, lane);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        x[n][i] = expf(x[n][i] - lse[64 * n + 8 * (i / 4) + 2 * (lane % 4) + i % 2]);   // p^T
    hopper::wgmma_wait<0>();
    fence_all(dp);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i)   // ds^T, fp32
        dp[n][i] = x[n][i] * (dp[n][i] - delta[64 * n + 8 * (i / 4) + 2 * (lane % 4) + i % 2]) *
                   p.scale;
    if constexpr (kScaleDs) {   // fp16: each row's exponent (see kDsExp0), then ds * 2^e
      float mx[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], fabsf(dp[n][i]));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int lim = ds_exp_limit(quad_max(mx[e]));   // the quad holds the row's 64 queries
        if (lim < ds_exp[e]) {
          const float f = exp2_int(lim - ds_exp[e]);
#pragma unroll
          for (int c = 0; c < NDC; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              dk[c][4 * j + 2 * e] *= f;
              dk[c][4 * j + 2 * e + 1] *= f;
            }
          ds_exp[e] = lim;
        }
      }
      const float f[2] = {exp2_int(ds_exp[0]), exp2_int(ds_exp[1])};
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[n][i] *= f[(i % 4) / 2];
    }

    // dV's products run while ds^T is split
    uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4], ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];
    to_split_fragments<T, BQ>(x, p_hi, p_lo);
    __syncwarp();
    fence_all(dv);
    hopper::wgmma_fence();
    issue_px<T, DS, BQ>(dv, p_hi, do_tile);
    issue_px<T, DS, BQ>(dv, p_lo, do_tile);
    hopper::wgmma_commit();
    to_split_fragments<T, BQ>(dp, ds_hi, ds_lo);
    __syncwarp();
    fence_all(dk);
    hopper::wgmma_fence();
    issue_px<T, DS, BQ>(dk, ds_hi, q_tile);
    issue_px<T, DS, BQ>(dk, ds_lo, q_tile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_all(dv);
    fence_all(dk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hopper::fence_regs(p_hi[kk]);
      hopper::fence_regs(p_lo[kk]);
      hopper::fence_regs(ds_hi[kk]);
      hopper::fence_regs(ds_lo[kk]);
    }
    hopper::mbar_arrive(&empty[s]);
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (kj[e] >= p.Tk) continue;
    const long long row = ((static_cast<long long>(b) * p.Tk + kj[e]) * p.KV + kvh) * p.dh;
    const float unscale = exp2_int(-ds_exp[e]);
#pragma unroll
    for (int c = 0; c < NDC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int d = 64 * c + 8 * j + 2 * (lane % 4) + u;
          if (d < p.dh) {
            dk_out[row + d] = from_float<T>(dk[c][4 * j + 2 * e + u] * unscale);
            dv_out[row + d] = from_float<T>(dv[c][4 * j + 2 * e + u]);
          }
        }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem_floats, const Params& p,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Tiles per head width (fp32 forward and dq, dk/dv in every dtype): 64 x 64
// everywhere up to Dh 128; at Dh 256 the backward kernels take 32-row tiles
// so their staged rows fit in 227 KB.
template <typename T, int D>
cudaError_t fwd(const Params& p, cudaStream_t s) {
  constexpr int BQ = 64, BK = fwd_block_k(0, D);
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.H, p.B);
  return launch(flash_fwd_kernel<T, D, BQ, BK>, grid, fwd_smem_floats<D, BQ, BK>(), p, s);
}

template <typename T, int D>
cudaError_t bwd_dq(const Params& p, cudaStream_t s) {
  constexpr int BQ = D > 128 ? 32 : 64, BK = 64;
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.H, p.B);
  return launch(flash_dq_kernel<T, D, BQ, BK>, grid, dq_smem_floats<D, BQ, BK>(), p, s);
}

template <typename T, int D>
cudaError_t bwd_dkv(const Params& p, cudaStream_t s) {
  constexpr int BQ = D > 128 ? 32 : 64, BK = D > 128 ? 32 : 64;
  const dim3 grid((p.Tk + BK - 1) / BK, p.KV, p.B);
  return launch(flash_dkv_kernel<T, D, BQ, BK>, grid, dkv_smem_floats<D, BQ, BK>(), p, s);
}

// The tensor-core kernels: tensor maps of the [B, T, heads, dh] inputs (q
// and dO with BQ-row boxes, k and v with BK-row boxes), then the launch.
template <typename T, int DS, bool kDq>
cudaError_t tensor_core(const Params& p, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  constexpr int NC = DS == 256 ? 1 : 2, BQ = NC * 64;
  constexpr int BK = kDq ? 64 : fwd_block_k(f16 ? 1 : 2, DS);
  CUtensorMap tq, tdo, tk, tv;
  bool ok = hopper::make_head_map(&tq, p.q, f16, p.B, p.Tq, p.H, p.dh, p.q_sb, p.q_st, p.q_sh, BQ) &&
            hopper::make_head_map(&tk, p.k, f16, p.B, p.Tk, p.KV, p.dh, p.k_sb, p.k_st, p.k_sh, BK) &&
            hopper::make_head_map(&tv, p.v, f16, p.B, p.Tk, p.KV, p.dh, p.v_sb, p.v_st, p.v_sh, BK);
  if (kDq)
    ok = ok && hopper::make_head_map(&tdo, p.dout, f16, p.B, p.Tq, p.H, p.dh, p.do_sb, p.do_st,
                                     p.do_sh, BQ);
  if (!ok) return cudaErrorInvalidValue;
  const int smem = tc_smem_bytes<DS, BQ, BK>(kDq ? 2 : 1);
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.H, p.B);
  cudaError_t e;
  if constexpr (kDq) {
    auto kernel = flash_dq_wgmma<T, DS, NC, BK>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, tc_threads(NC), smem, stream>>>(p, tq, tdo, tk, tv);
  } else {
    auto kernel = flash_fwd_wgmma<T, DS, NC, BK>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, tc_threads(NC), smem, stream>>>(p, tq, tk, tv);
  }
  return cudaGetLastError();
}

// The dk/dv tensor-core kernel: blocks of 128 keys (two consumer
// warpgroups), query tiles of 64.
template <typename T, int DS>
cudaError_t dkv_tensor_core(const Params& p, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  constexpr int NC = 2, BKV = NC * 64, BQ = 64;
  CUtensorMap tq, tdo, tk, tv;
  const bool ok =
      hopper::make_head_map(&tq, p.q, f16, p.B, p.Tq, p.H, p.dh, p.q_sb, p.q_st, p.q_sh, BQ) &&
      hopper::make_head_map(&tdo, p.dout, f16, p.B, p.Tq, p.H, p.dh, p.do_sb, p.do_st, p.do_sh,
                            BQ) &&
      hopper::make_head_map(&tk, p.k, f16, p.B, p.Tk, p.KV, p.dh, p.k_sb, p.k_st, p.k_sh, BKV) &&
      hopper::make_head_map(&tv, p.v, f16, p.B, p.Tk, p.KV, p.dh, p.v_sb, p.v_st, p.v_sh, BKV);
  if (!ok) return cudaErrorInvalidValue;
  constexpr int smem = dkv_tc_smem_bytes<DS, BKV, BQ>();
  auto kernel = flash_dkv_wgmma<T, DS, NC, BQ>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tk + BKV - 1) / BKV, p.KV, p.B);
  kernel<<<grid, tc_threads(NC), smem, stream>>>(p, tq, tdo, tk, tv);
  return cudaGetLastError();
}

enum Which { kFwd, kDq, kDkv };

template <typename T>
constexpr int dtype_code() {
  return std::is_same<T, float>::value ? 0 : std::is_same<T, __half>::value ? 1 : 2;
}

// The route, by dtype code and staged head width: bf16 / fp16 take the
// tensor-core kernels, except dk/dv at head width 256, whose dK and dV
// accumulators (256 fp32 registers a thread for 64 keys) do not fit a
// warpgroup's registers; fp32, and that dk/dv, the SIMT kernels. The Python
// wrapper reads it through ds_flash_route.
constexpr bool tensor_core_route(Which which, int dtype, int staged_dh) {
  return dtype != 0 && (which != kDkv || staged_dh <= 128);
}

// Launches per kernel, counted on the host after each launch and read
// through ds_flash_kernel_launches: which kernel a call actually went to.
enum Kernel { kFwdSimt, kFwdWgmma, kDqSimt, kDqWgmma, kDkvSimt, kDkvWgmma, kNumKernels };
long long g_launches[kNumKernels] = {};

cudaError_t counted(Kernel kernel, cudaError_t e) {
  if (e == cudaSuccess) ++g_launches[kernel];
  return e;
}

template <typename T, int D>
cudaError_t run(Which which, const Params& p, cudaStream_t s) {
  constexpr int code = dtype_code<T>();
  switch (which) {
    case kFwd:
      if constexpr (tensor_core_route(kFwd, code, D))
        return counted(kFwdWgmma, tensor_core<T, D, false>(p, s));
      else return counted(kFwdSimt, fwd<T, D>(p, s));
    case kDq:
      if constexpr (tensor_core_route(kDq, code, D))
        return counted(kDqWgmma, tensor_core<T, D, true>(p, s));
      else return counted(kDqSimt, bwd_dq<T, D>(p, s));
    default:
      if constexpr (tensor_core_route(kDkv, code, D))
        return counted(kDkvWgmma, dkv_tensor_core<T, D>(p, s));
      else return counted(kDkvSimt, bwd_dkv<T, D>(p, s));
  }
}

// Head widths up to 256 round up to a staged width of 64, 128 or 256; the
// extra columns are zero.
constexpr int staged_width(int dh) { return dh <= 64 ? 64 : dh <= 128 ? 128 : 256; }

template <typename T>
cudaError_t dispatch_width(Which which, const Params& p, cudaStream_t s) {
  if (p.dh <= 0 || p.dh > 256) return cudaErrorInvalidValue;
  switch (staged_width(p.dh)) {
    case 64: return run<T, 64>(which, p, s);
    case 128: return run<T, 128>(which, p, s);
    default: return run<T, 256>(which, p, s);
  }
}

int dispatch(Which which, const Params* p, int dtype, void* stream) {
  if (p->B == 0 || p->Tq == 0 || p->Tk == 0 || p->H == 0) return cudaSuccess;
  if (p->KV <= 0 || p->H % p->KV) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_width<float>(which, *p, s);
    case 1: return dispatch_width<__half>(which, *p, s);
    case 2: return dispatch_width<__nv_bfloat16>(which, *p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, k, v, dO and the
// outputs share it). Each returns a cudaError_t code.
extern "C" int ds_flash_fwd(const Params* p, int dtype, void* stream) {
  return dispatch(kFwd, p, dtype, stream);
}

extern "C" int ds_flash_bwd_dq(const Params* p, int dtype, void* stream) {
  return dispatch(kDq, p, dtype, stream);
}

extern "C" int ds_flash_bwd_dkv(const Params* p, int dtype, void* stream) {
  return dispatch(kDkv, p, dtype, stream);
}

// Keys per tile of the forward kernel for this dtype code and head width
// (the rounding tiles of p), or -1 for a width the kernels do not take.
extern "C" int ds_flash_fwd_block_k(int dtype, int dh) {
  if (dtype < 0 || dtype > 2 || dh <= 0 || dh > 256) return -1;
  return fwd_block_k(dtype, staged_width(dh));
}

// 1 where `which` (0 forward, 1 dq, 2 dk/dv) runs the tensor-core kernel
// for this dtype code and head width, 0 where it runs the SIMT kernel, -1
// for a code or width the kernels do not take.
extern "C" int ds_flash_route(int which, int dtype, int dh) {
  if (which < 0 || which > 2 || dtype < 0 || dtype > 2 || dh <= 0 || dh > 256) return -1;
  return tensor_core_route(static_cast<Which>(which), dtype, staged_width(dh)) ? 1 : 0;
}

// Launches so far of one kernel, in the order of enum Kernel: forward SIMT,
// forward wgmma, dq SIMT, dq wgmma, dk/dv SIMT, dk/dv wgmma; -1 past the
// end.
extern "C" long long ds_flash_kernel_launches(int kernel) {
  return kernel >= 0 && kernel < kNumKernels ? g_launches[kernel] : -1;
}

extern "C" const char* ds_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
