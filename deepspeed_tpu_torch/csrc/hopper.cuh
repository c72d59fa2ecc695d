// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA tensor-map loads and 1-D bulk copies, wgmma descriptors and the
// m64n64k16 wgmma products with fp32 accumulators. Header only; a kernel
// source includes it, and ops/cuda_build.py hashes every .cuh of csrc/ into
// each library's name so that an edit here rebuilds the kernels.
//
// Layout convention. Every operand tile in shared memory is stored as
// 64-element column blocks of 128 bytes per row, written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B (16-byte chunk c of row r lands at chunk
// c ^ (r % 8)), each block 1024-byte aligned. The same staged tile serves
// as a K-major operand (rows = M or N, the 64 columns = K) and as an
// MN-major operand (rows = K, the 64 columns = N) through the descriptor's
// layout and the instruction's transpose bit:
//   K-major:  rows 8 apart by 128 B, 8-row groups 1024 B apart (SBO); a
//             k-step of 16 elements moves the start address by 32 B.
//   MN-major: k rows 128 B apart, 8-row groups 1024 B apart (SBO); a k-step
//             of 16 rows moves the start address by 2048 B. An n64 product
//             covers one column block, so the leading offset is not used.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <array>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <set>
#include <type_traits>
#include <unordered_map>
#include <utility>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also tells the barrier to wait for `bytes` of TMA traffic.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of the given parity. A
// lost arrival traps (the launch fails with an error) instead of hanging
// the card; a sound pipeline waits a few microseconds at most.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t spins = 0;
  while (!mbar_try_wait(addr, parity)) {
    if (++spins == (1u << 24)) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// A 4-D tiled load of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 2-D and 3-D tiled loads, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A 1-D bulk copy of `bytes` contiguous bytes of global memory into shared
// memory, completing on `bar` (which a mbar_arrive_expect_tx told to wait
// for them). No tensor map: `bytes`, `src` and `dst` are multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A 4-byte cp.async into shared memory, zero-filled (nothing read) when
// `pred` is false; its completion is reported to an mbarrier by
// cp_async_arrive_noinc.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued so far has
// landed. noinc: the arrival is one of the barrier's expected count.
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Register rebalancing between warpgroups: every warp of a warpgroup
// executes the same one, the producer's release first feeding the
// consumers' request (the CTA's register pool is fixed at launch).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Shared-memory matrix descriptor for a 128-byte-swizzled tile starting at
// shared address `addr` (1024-byte aligned up to the k-step offset), its
// 8-row groups 1024 bytes apart. `lbo`, the leading offset in bytes, is read
// only by an MN-major operand wider than one 64-column block: the distance
// between its column blocks.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |   // leading offset
         (static_cast<uint64_t>(1024 >> 4) << 32) |             // stride offset
         (static_cast<uint64_t>(1) << 62);                      // 128-byte swizzle
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operand reads, TMA), ahead of a barrier that orders them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads of the CTA.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in place around asynchronous wgmma operations, so that the
// compiler neither reads an accumulator before wgmma_wait nor reuses an
// operand register while a product may still read it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_D32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_ACC32(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory.
// The accumulator layout (per warp w of the warpgroup, lane l):
//   d[4j + e] is row 16 w + l / 4 + 8 (e / 2), column 8 j + 2 (l % 4) + e % 2.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " HOPPER_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_ACC32(d)
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_ACC32(d)
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (four packed pairs
// per thread, the accumulator layout's columns 2 (l % 4) and 8 + 2 (l % 4)
// of rows l / 4 and l / 4 + 8), B MN-major in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " HOPPER_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HOPPER_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HOPPER_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers (wgmma_rs_mn's
// fragments), B K-major in shared memory (as wgmma_ss's B).
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " HOPPER_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : HOPPER_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : HOPPER_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
  }
}

#undef HOPPER_D32
#undef HOPPER_ACC32

#define HOPPER_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define HOPPER_ACC64(d) \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),    \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),    \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),    \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),    \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),    \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128] from shared memory. B K-major
// (kMnB false) or MN-major (kMnB true: read through the transpose bit, its
// two 64-column blocks `lbo` bytes apart in the descriptor); A K-major, or
// MN-major with kMnA (64 rows of M in one 128-byte row per k, a k-step of
// 16 rows 2048 bytes on, as an MN-major B's column block). The
// accumulator layout is wgmma_ss's with j running to 15.
template <typename T, bool kMnB, bool kMnA = false>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  constexpr int ta = kMnA ? 1 : 0, tb = kMnB ? 1 : 0;
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " HOPPER_D64
        ", %64, %65, p, 1, 1, %67, %68;\n}\n"
        : HOPPER_ACC64(d)
        : "l"(a), "l"(b), "r"(accumulate), "n"(ta), "n"(tb));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
        ", %64, %65, p, 1, 1, %67, %68;\n}\n"
        : HOPPER_ACC64(d)
        : "l"(a), "l"(b), "r"(accumulate), "n"(ta), "n"(tb));
  }
}

#undef HOPPER_D64
#undef HOPPER_ACC64

// Two fp32 values rounded to T and packed as one 32-bit register, the first
// in the low half (the lower column).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library does not link libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &status);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    return e == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// cuTensorMapEncodeTiled, a driver call, needs a context current on the
// calling thread. A thread whose CUDA work so far needed none has none: a
// PyTorch autograd worker for device 0 whose first CUDA call is a launch of
// this library (PyTorch never sets device 0 there, the runtime's default).
// The runtime binds the current device's primary context when a call needs
// it; cudaSetDevice to the device cudaGetDevice names does that, and
// changes nothing where a context is current. Once per thread.
inline bool bind_context() {
  thread_local bool bound = false;
  if (!bound) {
    int dev = 0;
    bound = cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess;
  }
  return bound;
}

// Tensor map of a `rank`-dim tensor of element type `type` (dims innermost
// first, the innermost contiguous; `strides` in bytes for dims 1..rank-1),
// read in boxes of `box` elements per dim, 128-byte swizzled (box[0] of 128
// bytes). Boxes past an edge, wholly or in part, read zeros. Returns false
// if cuTensorMapEncodeTiled refuses.
inline bool make_map_of(CUtensorMap* map, const void* base, CUtensorMapDataType type, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || !bind_context()) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// make_map_of, remembered by its arguments: for a tensor that calls read at
// one address again and again (a weight, a KV pool), so that only the
// first call pays cuTensorMapEncodeTiled. A map holds nothing but these
// arguments, so an entry is right for whatever tensor lies at that address
// with that shape later. At most 4096 entries; past that the table starts
// afresh.
inline bool make_map_of_cached(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                               int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                               const cuuint32_t* box) {
  using Key = std::array<uint64_t, 16>;
  struct Hash {
    size_t operator()(const Key& k) const {
      uint64_t h = 1469598103934665603ull;
      for (uint64_t v : k) h = (h ^ v) * 1099511628211ull;
      return static_cast<size_t>(h);
    }
  };
  // the maps kept as plain bytes: CUtensorMap is 64-byte aligned
  using Bytes = std::array<uint64_t, sizeof(CUtensorMap) / 8>;
  static_assert(sizeof(CUtensorMap) % 8 == 0, "CUtensorMap is whole words");
  static std::mutex mu;
  static std::unordered_map<Key, Bytes, Hash> maps;
  if (rank < 1 || rank > 5) return false;
  Key key{};
  key[0] = reinterpret_cast<uint64_t>(base);
  key[1] = static_cast<uint64_t>(type) << 8 | static_cast<uint64_t>(rank);
  for (int i = 0; i < rank; ++i) {
    key[2 + i] = dims[i];
    key[7 + i] = box[i];
    if (i > 0) key[11 + i] = strides[i - 1];
  }
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = maps.find(key);
  if (hit != maps.end()) {
    std::memcpy(map, &hit->second, sizeof(CUtensorMap));
    return true;
  }
  if (!make_map_of(map, base, type, rank, dims, strides, box)) return false;
  if (maps.size() >= 4096) maps.clear();
  Bytes bytes;
  std::memcpy(bytes.data(), map, sizeof(CUtensorMap));
  maps.emplace(key, bytes);
  return true;
}

// The current device's SM count, asked of the runtime once per device; 0
// if it cannot be read.
inline int sm_count() {
  static int counts[64] = {};
  static std::mutex mu;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  std::lock_guard<std::mutex> lock(mu);
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) on the
// current device, once per kernel, size and device (the attribute is the
// device's).
inline cudaError_t allow_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<std::pair<const void*, int>, int>> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_pair(std::make_pair(kernel, bytes), dev);
  std::lock_guard<std::mutex> lock(mu);
  if (done.count(key)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.insert(key);
  return e;
}

// make_map_of for a 16-bit tensor (fp16 or bf16), box[0] = 64.
inline bool make_map(CUtensorMap* map, const void* base, bool fp16, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  return make_map_of(map, base,
                     fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     rank, dims, strides, box);
}

// Tensor map of one [B, T, heads, dh] 16-bit tensor with element strides
// (sb, st, sh) and a contiguous last dim, read in boxes of 64 columns x
// `rows` rows of one head, 128-byte swizzled. Boxes past T or dh read zeros.
// Dims of extent 1 may carry any stride. Returns false if the driver refuses.
inline bool make_head_map(CUtensorMap* map, const void* base, bool fp16, int B, int T, int heads,
                          int dh, long long sb, long long st, long long sh, int rows) {
  // a stride of an extent-1 dim is never used: give it the contiguous value
  if (heads == 1) sh = dh;
  if (T == 1) st = static_cast<long long>(heads) * sh;
  if (B == 1) sb = static_cast<long long>(T) * st;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  return make_map(map, base, fp16, 4, dims, strides, box);
}

}  // namespace hopper
