// Hopper (sm_90a) building blocks of the 16-bit (bf16 and f16)
// flash-attention kernels (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu):
// TMA tile loads with mbarrier completion, warpgroup matrix multiplies
// (wgmma) with shared-memory descriptors, register reallocation between
// warpgroups, and the host-side tensor maps. The element type E
// (__nv_bfloat16 or __half) picks the wgmma type, the tensor map's type and
// the rounding of the P and dS fragments; the layouts are the same.
//
// Layouts, pinned on the card against torch.matmul:
// * A tile of R rows of a [heads, T, d] 16-bit tensor lands in shared memory
//   as Dp/64 sub-tiles of [R][64] (128 bytes a row, the 128-byte swizzle of
//   TMA), each sub-tile 1024-byte aligned, where Dp, the padded width, is
//   the smallest of 64, 128 and 256 that is at least d. Rows at or past T
//   and columns at or past d read as zero, so the padding adds nothing to a
//   product over the head dim, and output columns past d are never stored.
// * K-major operand (the reduction runs along a row, e.g. Q or K in q.k^T):
//   descriptor SBO = 1024 bytes (8 rows), LBO unused; the k-th 16-column step
//   adds 32 bytes to the start address inside a sub-tile.
// * MN-major operand (the reduction runs down the rows, e.g. V in P.V): the
//   descriptor's transpose bit, SBO = 1024 bytes (8 rows), LBO = the bytes
//   between two 64-column sub-tiles; the k-th 16-row step adds 2048 bytes.
// * Accumulator of m64nNk16, f32: thread t of the warpgroup (warp w = t/32,
//   lane l) holds d[4j + e] at row 16w + l/4 + 8(e/2), column
//   8j + 2(l%4) + (e%2). Registers d[8k .. 8k+7], rounded to E and packed
//   in pairs, are exactly the A fragment of the k-th 16-wide step of a
//   following register-A wgmma: no shuffles between the two products.
//
// This file has a plain C interface and includes no PyTorch header.
// libcuda's cuTensorMapEncodeTiled is fetched through the CUDA runtime, so
// the libraries need no -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fedml_flash {
namespace sm90 {

template <typename E>
constexpr bool kIsBf16 = std::is_same<E, __nv_bfloat16>::value;

// --- shared memory and mbarriers -------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dynamic shared memory rounded up to the 1024 bytes the swizzle needs
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait for the completion of the barrier's phase of this parity. A wait
// that has not completed after 2^35 cycles (about 17 s) can never complete:
// it traps, so that the launch fails with an error instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
  }
}

// --- TMA ---------------------------------------------------------------------

// box (64 columns, rows, 1) at (column c0, row c1, head c2) into dst
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 4 bytes global -> shared without waiting; zeros when !valid (src is then
// not read). Completion is reported by cp_async_arrive.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// one arrival on bar once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// every 64-column sub-tile of a D-wide (padded) tile of `rows` rows starting
// at row `row0` of head `head`
template <int D, int ROWS, typename E>
__device__ __forceinline__ void tma_load_rows(E* dst, const CUtensorMap* map, uint64_t* bar,
                                              int row0, int head) {
#pragma unroll
  for (int s = 0; s < D / 64; ++s) tma_load_3d(dst + s * ROWS * 64, map, bar, 64 * s, row0, head);
}

// named barriers 1..15 (0 is __syncthreads): `threads` arrivals complete one
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- warpgroup registers and wgmma -------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence/commit/wait instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  uint64_t d = (smem_addr(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// The descriptor of a whole tile, made opaque where it is taken: the
// compiler then forms each step's descriptor (base + a constant) at its
// wgmma instead of keeping every step's 64-bit descriptor live across the
// loop, which starves the accumulators of registers.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(d));
  return d;
}

// K-major operand: a [ROWS][D] tile held as 64-column sub-tiles...
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) {
  return opaque(desc(tile, 16, 1024));
}
// ...and its 16-column step k (start address in 16-byte units)
template <int ROWS>
__device__ __forceinline__ uint64_t k_step(uint64_t base, int k) {
  return base + (((k / 4) * ROWS * 128 + (k % 4) * 32) >> 4);
}

// MN-major operand: a [ROWS][D] tile held as 64-column sub-tiles...
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile) {
  return opaque(desc(tile, ROWS * 128, 1024));
}
// ...and its 16-row step k
__device__ __forceinline__ uint64_t mn_step(uint64_t base, int k) { return base + k * 128; }

// 2^x in one MUFU instruction (ex2.approx: about 2^-22 relative error,
// subnormal results flushed to zero, 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to the 16-bit element type E (bf16 or f16) and
// packed in one register, the low one first: a pair of an A fragment, or
// two neighbouring columns of an output row.
template <typename E>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (kIsBf16<E>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The operand lists of the wgmma instructions below: the accumulator
// registers d[i] .. d[i + n - 1] and their placeholders %0 .. %(n-1).
#define FEDML_ACC8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FEDML_ACC16(i) FEDML_ACC8(i), FEDML_ACC8(i + 8)
#define FEDML_ACC32(i) FEDML_ACC16(i), FEDML_ACC16(i + 16)
#define FEDML_ACC64(i) FEDML_ACC32(i), FEDML_ACC32(i + 32)
#define FEDML_ACC128(i) FEDML_ACC64(i), FEDML_ACC64(i + 64)
#define FEDML_REG16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define FEDML_REG32 \
  FEDML_REG16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FEDML_REG64                                                                          \
  FEDML_REG32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47" \
              ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define FEDML_REG128                                                                          \
  FEDML_REG64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79" \
              ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" \
              ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109" \
              ", %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122"     \
              ", %123, %124, %125, %126, %127"

// m64nNk16 with A and B from shared memory (both K-major); the operands
// after the N/2 accumulators are %NA (A), %NB (B) and %NP (accumulate or not)
#define FEDML_WGMMA_SS(N, TY, REGS, NA, NB, NP, ACC)                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" NP ", 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" REGS    \
               "}, %" NA ", %" NB ", p, 1, 1, 0, 0;\n}\n"                              \
               : ACC                                                                    \
               : "l"(da), "l"(db), "r"(acc))
// m64nNk16 with A from registers (%A0 .. %A3) and B from shared memory
// (MN-major, through the transpose bit)
#define FEDML_WGMMA_RS(N, TY, REGS, A0, A1, A2, A3, NB, NP, ACC)                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" NP ", 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" REGS      \
               "}, {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" NB ", p, 1, 1, 1;\n}\n"       \
               : ACC                                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc))

// D[64 x N] (+)= A[64 x 16] * B[16 x N] in E (bf16 or f16) with f32 sums, A
// and B K-major in shared memory; N is 32, 64 or 128
template <typename E, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: no instance for this N");
  if constexpr (N == 32) {
    if constexpr (kIsBf16<E>) FEDML_WGMMA_SS(32, "bf16", FEDML_REG16, "16", "17", "18", FEDML_ACC16(0));
    else FEDML_WGMMA_SS(32, "f16", FEDML_REG16, "16", "17", "18", FEDML_ACC16(0));
  } else if constexpr (N == 64) {
    if constexpr (kIsBf16<E>) FEDML_WGMMA_SS(64, "bf16", FEDML_REG32, "32", "33", "34", FEDML_ACC32(0));
    else FEDML_WGMMA_SS(64, "f16", FEDML_REG32, "32", "33", "34", FEDML_ACC32(0));
  } else {
    if constexpr (kIsBf16<E>) FEDML_WGMMA_SS(128, "bf16", FEDML_REG64, "64", "65", "66", FEDML_ACC64(0));
    else FEDML_WGMMA_SS(128, "f16", FEDML_REG64, "64", "65", "66", FEDML_ACC64(0));
  }
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N], A in registers, B MN-major in
// shared memory; N is 64, 128 or 256
template <typename E, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_rs: no instance for this N");
  if constexpr (N == 64) {
    if constexpr (kIsBf16<E>)
      FEDML_WGMMA_RS(64, "bf16", FEDML_REG32, "32", "33", "34", "35", "36", "37", FEDML_ACC32(0));
    else
      FEDML_WGMMA_RS(64, "f16", FEDML_REG32, "32", "33", "34", "35", "36", "37", FEDML_ACC32(0));
  } else if constexpr (N == 128) {
    if constexpr (kIsBf16<E>)
      FEDML_WGMMA_RS(128, "bf16", FEDML_REG64, "64", "65", "66", "67", "68", "69", FEDML_ACC64(0));
    else
      FEDML_WGMMA_RS(128, "f16", FEDML_REG64, "64", "65", "66", "67", "68", "69", FEDML_ACC64(0));
  } else {
    if constexpr (kIsBf16<E>)
      FEDML_WGMMA_RS(256, "bf16", FEDML_REG128, "128", "129", "130", "131", "132", "133",
                     FEDML_ACC128(0));
    else
      FEDML_WGMMA_RS(256, "f16", FEDML_REG128, "128", "129", "130", "131", "132", "133",
                     FEDML_ACC128(0));
  }
}

#undef FEDML_WGMMA_RS
#undef FEDML_WGMMA_SS
#undef FEDML_REG128
#undef FEDML_REG64
#undef FEDML_REG32
#undef FEDML_REG16
#undef FEDML_ACC128
#undef FEDML_ACC64
#undef FEDML_ACC32
#undef FEDML_ACC16
#undef FEDML_ACC8

// --- host: tensor maps -------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// [heads, t, d] contiguous E as the 3-D map (d, t, heads) with boxes of
// (64, rows, 1) and the 128-byte swizzle; reads past t or past d fill with
// zeros, so a ragged tile never touches the next head's rows, and a box of 64
// columns over a row narrower than its sub-tile (d < 64, or the last
// sub-tiles of the padded width) lands with zeros past d. d is a multiple of
// 8, so a row's stride is a multiple of the 16 bytes the map needs.
template <typename E>
cudaError_t rows_map(CUtensorMap* map, const void* base, int heads, int t, int d, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn || (reinterpret_cast<uintptr_t>(base) & 15)) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      kIsBf16<E> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace fedml_flash
