// Weight-only int8 GEMM: y[m, n] = cast(scale[n] * sum_k x[m, k] * float(wq[n, k])).
//
// Replaces: no TPU kernel. The JAX package computes this product outside any
// Pallas kernel, as lax.dot_general on the int8 operand with f32 accumulation
// (fedml_tpu/models/transformer.py:149-155, LoRALinear under
// weight_quant="int8"), and XLA widens the int8 operand inside its matmul
// pipeline. PyTorch has no mixed bf16 x s8 product: F.linear on a widened
// copy of the weights would write (and read back) a bf16 copy of every
// kernel on every decoded token. These kernels read the int8 weights once
// and widen them on chip.
//
// x [M, K] is bf16 or f32, wq [N, K] int8 row-major (torch's [out, in]
// layout), scale [N] f32, y [M, N] in x's dtype; accumulation in f32, the
// scale applied in f32 before the one cast of the result. K must be a
// multiple of 16 and every pointer 16-byte aligned (the wrapper checks).
//
// Widening is exact: |wq| <= 127 has 7 significant bits and bf16 holds 8, and
// a bf16 x bf16 product is exact in f32. So the bf16 designs on the tensor
// cores compute the plain version's function; only the order of the f32 sums
// differs. Four designs (enum Design), picked by M and x's dtype (design_for;
// ops/int8_matmul.py design_for states the same rule):
//
// kGemvMma, bf16 x, 2 <= M <= 8 (decode rows). Bound by bytes: the N*K weight
// bytes at 3.35 TB/s. The product runs on the tensor cores as
// mma.sync.m16n8k16 (bf16 in, f32 sums): 16 output channels are A, the up to
// 8 tokens fill n8 as B. Each lane streams 16 int8 of a row with one 128-bit
// evict-first load and widens them exactly to bf16 pairs in registers (byte
// permute, the 2^23 trick, one add, the f32's high half); K is taken in the
// order that makes those 16 bytes exactly four k-steps of its A fragment, and
// x is read in the same order straight into the B fragment (the sum does not
// depend on the order of k; every warp of an SM reads the same x through L1,
// so staging it in shared memory would only add a barrier). The warps of a
// block split K and reduce their partial tiles in shared memory, so that
// N = 4096 still keeps every SM streaming: 16 warps over 16 channels below
// N = 8448, else 8 warps over 32 channels (the faster of the layouts measured
// at Llama-2-7B's shapes). A weight byte costs under three instructions where
// kGemvWarp spends M f32 FMAs on it, which held kGemvWarp to 32-44% of its
// bound at M = 8.
//
// kSm90WgmmaTma, bf16 x, M > 8 (prefill). Bound by operations above M of
// about 150 (an int8 weight byte carries 2*M operations; the bf16 ridge is
// 295 a byte), by the weight bytes below. Warp-specialised: one producer warp
// keeps a ring of stages full through TMA (x tiles bf16 [BT][128] as two
// 128-byte-swizzled sub-tiles, wq tiles int8 [BN][128] with the same
// swizzle; zeros past M, N and K), mbarriers full and empty. Each consumer
// warpgroup owns 64 output channels: the product is swapped, y^T = wq . x^T,
// so the weights are the A operand in registers, widened straight from the
// int8 tile into wgmma's A fragment, and x is the K-major B operand read by
// wgmma from shared memory (m64nBTk16, f32 accumulators); no widened copy is
// ever stored (widening into a swizzled bf16 tile for wgmma with both operands
// in shared memory was the other layout; PERF.md gives the two designs'
// times). The epilogue stages the f32 tile in shared memory, applies
// scale[n], casts once and stores whole rows of y. At M > 128 a block is two
// consumers x 128 tokens (at M = 512, N = 4096 one wave of 128 blocks); at
// M <= 128 it is one consumer of 64 channels and the smallest token tile
// (16, 32, 64, 128) that holds M, and where the channel tiles leave SMs
// idle (N = 4096: 64 tiles) K is split over a cluster of 2 or 4 blocks; the
// cluster reduces its partial tiles through distributed shared memory in
// rank order, so the result does not depend on scheduling.
//
// kGemvWarp (f32 x at M <= 8, and bf16 at M = 1) and kTiledSimt (f32 x,
// M > 8) are the first port's SIMT designs: f32 FMAs, the weights widened in
// registers. At M = 1 kGemvMma was faster at three of Llama-2-7B's four
// projection shapes and 3% slower at 4096 x 32000, so M = 1 stays here
// (kMmaMinM). The f32 path keeps them: the tensor cores would need TF32,
// which misses the f32 limit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace fedml_int8 {

using namespace fedml_flash::sm90;

enum Design { kGemvWarp = 0, kTiledSimt = 1, kGemvMma = 2, kSm90WgmmaTma = 3, kDesigns = 4 };

constexpr int kGemvMaxM = 8;
constexpr int kRows = 4;   // output channels a warp computes (gemv_warp)
constexpr int kWarps = 4;  // warps a block (gemv_warp)

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Four signed int8 packed in a 32-bit word -> four exact floats.
__device__ __forceinline__ void widen4(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;  // each byte now holds b + 128
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
}

// Sixteen consecutive x values as floats, from a 16-element aligned group.
__device__ __forceinline__ void load_x16(const float* p, float* out) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(q + i);
    out[4 * i + 0] = v.x;
    out[4 * i + 1] = v.y;
    out[4 * i + 2] = v.z;
    out[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void load_x16(const __nv_bfloat16* p, float* out) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 v = __ldg(q + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // bf16 -> f32 is exact: the high half of the word
      out[8 * i + 2 * j + 0] = __uint_as_float(w[j] << 16);
      out[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
}

// --- kGemvWarp and kTiledSimt: SIMT ----------------------------------------------

template <typename T, int M>
__global__ void __launch_bounds__(kWarps * 32)
gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
            const float* __restrict__ scale, T* __restrict__ y, int N, int K) {
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (n0 >= N) return;  // the whole warp leaves; the kernel has no barrier
  float acc[kRows][M];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int m = 0; m < M; ++m) acc[r][m] = 0.0f;

  const int groups = K >> 4;  // 16 columns a group
  for (int g = lane; g < groups; g += 32) {
    uint4 w[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      w[r] = n0 + r < N
          ? __ldcs(reinterpret_cast<const uint4*>(wq + (size_t)(n0 + r) * K) + g)
          : make_uint4(0u, 0u, 0u, 0u);
    }
    float wf[kRows][16];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      widen4(w[r].x, wf[r] + 0);
      widen4(w[r].y, wf[r] + 4);
      widen4(w[r].z, wf[r] + 8);
      widen4(w[r].w, wf[r] + 12);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float xv[16];
      load_x16(x + (size_t)m * K + (size_t)g * 16, xv);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[r][m] = fmaf(xv[i], wf[r][i], acc[r][m]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float v = acc[r][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
      // every lane holds the sum; one lane a (row, channel) writes it
      if (lane == ((r * M + m) & 31) && n0 + r < N)
        y[(size_t)m * N + n0 + r] = from_float<T>(v * scale[n0 + r]);
    }
  }
}

constexpr int kBM = 64, kBN = 64, kBK = 16, kTiledThreads = 256;

// x tile [BM, BK] from rows m0.., columns k0..; thread t loads 4 values of
// row t / 4 at column (t % 4) * 4 and stores them transposed, xs[k][m].
__device__ __forceinline__ void load_x4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
             const float* __restrict__ scale, T* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) float xs[kBK][kBM];
  __shared__ __align__(16) float ws[kBK][kBN];
  const int t = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tx = t % 16, ty = t / 16;      // this thread's 4 channels, 4 rows
  const int lr = t / 4, lc = (t % 4) * 4;  // the 4 values it stages of x and of wq
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (m0 + lr < M) load_x4(x + (size_t)(m0 + lr) * K + k0 + lc, xv);
    float wv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (n0 + lr < N)
      widen4(*reinterpret_cast<const uint32_t*>(wq + (size_t)(n0 + lr) * K + k0 + lc), wv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xs[lc + i][lr] = xv[i];
      ws[lc + i][lr] = wv[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) y[(size_t)m * N + n] = from_float<T>(acc[i][j] * scale[n]);
    }
  }
}


// --- helpers of the tensor-core designs ----------------------------------------

// Four int8 in a word -> two bf16 pairs, exact: lo holds bytes 0, 1 (byte 0
// in its low half), hi bytes 2, 3.
__device__ __forceinline__ void widen_pairs(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // each byte now holds b + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
  // an integer of at most 8 significant bits: its f32's high half is its bf16
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// D[16 x 8] += A[16 x 16] * B[16 x 8], bf16 in, f32 sums (one warp)
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// box (c0 column, c1 row) of a 2-D tensor map into dst
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// every thread of every block of the cluster; orders shared-memory writes
// before the barrier with reads after it, across the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// four floats at shared address `a` of block `rank` of the cluster
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t a, uint32_t rank) {
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(a), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(ra)
               : "memory");
  return v;
}

// D[64 x N] += A[64 x 16] * B[16 x N]: A in registers, B K-major in shared
// memory (128-byte swizzle). N is the token tile.
template <int N>
__device__ __forceinline__ void wgmma_rk(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rk<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rk<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rk<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rk<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --- kGemvMma: decode rows on mma.sync ------------------------------------------

constexpr int kMmaMinM = 2;  // bf16 rows from this M up take kGemvMma
static_assert(kMmaMinM == 2, "bf16 gemv_warp is built for M = 1 alone");
constexpr int kMmaWarpsNarrow = 16;  // warps a block of 16 channels
constexpr int kMmaWarpsWide = 8;     // warps a block of 32 channels
constexpr int kMmaChunksNarrow = 4;  // chunks of 64 columns a warp loads a round, 16 channels
constexpr int kMmaChunksWide = 2;    // the same, 32 channels
constexpr int kMmaWideMinN = 8448;   // 32 channels a block from this N (264 blocks)

// One block of W warps: 16 * R output channels from n0, all M (<= 8)
// tokens. Warp w takes the 64-column chunks w, w + W, ... of K, U of them a
// round. Lane (g = lane / 4, q = lane % 4) loads 16 bytes of rows
// n0 + 16r + g and + 8 at column 64c + 16q, and the 16 bf16 of token g at the
// same columns. K order inside a chunk: logical k-step j, the fragment's
// columns 2q, 2q + 1 are physical 16q + 4j + {0, 1} and 2q + 8, 2q + 9 are
// 16q + 4j + {2, 3}, for A and B alike. A lane's 16 bytes lie wholly inside
// or wholly past K (K is a multiple of 16). Every load is issued, from a
// clamped address where it lies past an edge, and zeroed after, so no branch
// splits a round's loads.
template <int R, int W, int U>
__global__ void __launch_bounds__(W * 32)
gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M, int N,
                int K) {
  constexpr int BN = 16 * R;
  __shared__ float red[W][BN][9];  // partial sums [warp][channel][token], padded
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int chunks = (K + 63) >> 6;

  float d[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[r][i] = 0.0f;

  // addresses are formed anew each round: kept live across the loop, they
  // make ptxas spill
  for (int c = warp; c < chunks; c += W * U) {
    uint4 w[U][R][2], xv[U][2];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = ((c + W * u) << 6) + (q << 4);
      ok[u] = c + W * u < chunks && col < K;
      const int at = ok[u] ? col : 0;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = min(n0 + 16 * r + 8 * h + g, N - 1);
          w[u][r][h] = __ldcs(reinterpret_cast<const uint4*>(wq + (size_t)row * K + at));
        }
      const uint4* xp = reinterpret_cast<const uint4*>(x + (size_t)min(g, M - 1) * K + at);
      xv[u][0] = __ldg(xp);
      xv[u][1] = __ldg(xp + 1);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool x_ok = ok[u] && g < M;
      const uint32_t xb[8] = {x_ok ? xv[u][0].x : 0u, x_ok ? xv[u][0].y : 0u,
                              x_ok ? xv[u][0].z : 0u, x_ok ? xv[u][0].w : 0u,
                              x_ok ? xv[u][1].x : 0u, x_ok ? xv[u][1].y : 0u,
                              x_ok ? xv[u][1].z : 0u, x_ok ? xv[u][1].w : 0u};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // a row past N, or columns past K, read as zero (x is zero there
        // too, but a clamped row's int8 times a finite x is not)
        const bool ok0 = ok[u] && n0 + 16 * r + g < N, ok1 = ok[u] && n0 + 16 * r + 8 + g < N;
        const uint32_t w0[4] = {ok0 ? w[u][r][0].x : 0u, ok0 ? w[u][r][0].y : 0u,
                                ok0 ? w[u][r][0].z : 0u, ok0 ? w[u][r][0].w : 0u};
        const uint32_t w1[4] = {ok1 ? w[u][r][1].x : 0u, ok1 ? w[u][r][1].y : 0u,
                                ok1 ? w[u][r][1].z : 0u, ok1 ? w[u][r][1].w : 0u};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t a0, a1, a2, a3;
          widen_pairs(w0[j], a0, a2);  // row g: columns 2q, 2q+1 and 2q+8, 2q+9
          widen_pairs(w1[j], a1, a3);  // row g + 8
          mma_16816(d[r], a0, a1, a2, a3, xb[2 * j], xb[2 * j + 1]);
        }
      }
    }
  }

  // d[r]: channels 16r + g (0, 1) and + 8 (2, 3), tokens 2q and 2q + 1. The
  // lane's place is read anew: kept live across the loop, ptxas spills it.
  uint32_t tid;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid));
  float* mine = &red[tid >> 5][(tid & 31) >> 2][2 * (tid & 3)];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mine[(16 * r) * 9] = d[r][0];
    mine[(16 * r) * 9 + 1] = d[r][1];
    mine[(16 * r + 8) * 9] = d[r][2];
    mine[(16 * r + 8) * 9 + 1] = d[r][3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * BN; i += W * 32) {
    const int m = i / BN, ch = i % BN, n = n0 + ch;
    if (n >= N) continue;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) v += red[w][ch][m];  // a fixed order
    y[(size_t)m * N + n] = __float2bfloat16(v * scale[n]);
  }
}

// --- kSm90WgmmaTma: prefill on wgmma, fed by TMA -----------------------------------

constexpr int kKT = 128;  // K columns a stage

// C consumer warpgroups of 64 channels (BN = 64 C), a token tile of BT, K
// split over a cluster of S blocks.
template <int C, int BT, int S>
struct Prefill {
  static constexpr int kBN = 64 * C;
  static constexpr int kXBytes = BT * kKT * 2;  // two [BT][64] bf16 sub-tiles
  static constexpr int kWBytes = kBN * kKT;     // [BN][128] int8
  static constexpr int kStageBytes = kXBytes + kWBytes;
  // one block an SM with two consumers; two with one (ring below 112 KB)
  static constexpr int kStages =
      C == 2 ? 4 : ((112 * 1024 - 2048) / kStageBytes > 8 ? 8 : (112 * 1024 - 2048) / kStageBytes);
  static constexpr int kRedStride = kBN + 4;  // f32 row of the epilogue's tile, padded
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static constexpr int kThreads = 128 * C + 32;  // + the producer warp
  static_assert(kStages >= 2, "ring too shallow");
  static_assert(BT * kRedStride * 4 <= kStages * kStageBytes, "epilogue tile does not fit");
  static_assert(kXBytes % 1024 == 0 && kWBytes % 1024 == 0, "tiles must stay 1024-aligned");
  static_assert(BT % S == 0, "each block of the cluster reduces whole token rows");
};

template <int C, int BT, int S>
__global__ void __launch_bounds__(Prefill<C, BT, S>::kThreads, C == 1 ? 2 : 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
             const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M, int N,
             int K) {
  using P = Prefill<C, BT, S>;
  constexpr int ST = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * P::kStageBytes);
  uint64_t* empty = full + ST;
  auto stage_x = [&](int s) { return ring + s * P::kStageBytes; };
  auto stage_w = [&](int s) { return ring + s * P::kStageBytes + P::kXBytes; };

  const int n0 = blockIdx.x * P::kBN, m0 = blockIdx.y * BT;
  const int split = S > 1 ? (int)cluster_rank() : 0;
  const int ktiles = (K + kKT - 1) / kKT;
  const int kt0 = split * ktiles / S, kt1 = (split + 1) * ktiles / S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * C) {
    // producer: lane 0 issues every load
    if (lane == 0) {
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int st = i % ST;
        mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);
        mbar_expect_tx(&full[st], P::kStageBytes);
        tma_load_2d(stage_x(st), &tx, &full[st], kt * kKT, m0);
        tma_load_2d(stage_x(st) + BT * 128, &tx, &full[st], kt * kKT + 64, m0);
        tma_load_2d(stage_w(st), &tw, &full[st], kt * kKT, n0);
      }
    }
    __syncwarp();
  } else {
    const int c = warp >> 2, w = warp & 3;
    const int g = lane >> 2, q = lane & 3;
    // this lane's A rows: channel r0 = 64c + 16w + g of the tile and r0 + 8;
    // both are g modulo 8, so the 128-byte swizzle moves chunk j to j ^ g
    const int r0 = 64 * c + 16 * w + g;
    const uint32_t sel = (q & 1) ? 0x7632u : 0x5410u;  // the pair of its half-words
    const int xo = 4 * (q >> 1);
    float acc[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[i] = 0.0f;

    for (int i = 0; i < kt1 - kt0; ++i) {
      const int st = i % ST;
      mbar_wait(&full[st], (i / ST) & 1);
      const uint8_t* row0 = stage_w(st) + r0 * 128;
      const uint8_t* row1 = row0 + 8 * 128;
      // A fragment of k-step j: row r0 columns 16j + 2q, +1 (a0) and
      // 16j + 8 + 2q, +1 (a2); row r0 + 8 likewise (a1, a3)
      uint32_t a[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int off = ((j ^ g) << 4) + xo;
        const uint32_t u0 = *reinterpret_cast<const uint32_t*>(row0 + off);
        const uint32_t v0 = *reinterpret_cast<const uint32_t*>(row0 + off + 8);
        const uint32_t u1 = *reinterpret_cast<const uint32_t*>(row1 + off);
        const uint32_t v1 = *reinterpret_cast<const uint32_t*>(row1 + off + 8);
        widen_pairs(__byte_perm(u0, v0, sel), a[j][0], a[j][2]);
        widen_pairs(__byte_perm(u1, v1, sel), a[j][1], a[j][3]);
      }
      const uint64_t dx = desc_k_major(reinterpret_cast<const __nv_bfloat16*>(stage_x(st)));
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j) wgmma_rk<BT>(acc, a[j], k_step<BT>(dx, j));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // the f32 tile [BT][BN] (token-major) over the ring, once every consumer
    // is done with it: acc[4j + e] is channel r0 + 8(e / 2), token 8j + 2q + e % 2
    named_sync(1, 128 * C);
    float* red = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * j + 2 * q + (e & 1)) * P::kRedStride + r0 + 8 * (e >> 1)] = acc[4 * j + e];
    if (S == 1) named_sync(1, 128 * C);
  }
  if (S > 1) {
    __syncwarp();
    cluster_sync();  // every block's partial tile is written
  }

  if (warp < 4 * C) {
    // block `split` of the cluster reduces token rows [split, split + 1) * BT / S
    // over the cluster's tiles in rank order, scales, casts and stores them
    constexpr int kRows = BT / S, kQuads = P::kBN / 4;
    const uint32_t red_a = smem_addr(ring);
    const bool vec = (N & 3) == 0;
    for (int i = threadIdx.x; i < kRows * kQuads; i += 128 * C) {
      const int tok = split * kRows + i / kQuads, n = n0 + 4 * (i % kQuads), m = m0 + tok;
      if (m >= M || n >= N) continue;
      const uint32_t a = red_a + (uint32_t)(tok * P::kRedStride + 4 * (i % kQuads)) * 4u;
      float4 v;
      if (S == 1) {
        v = *reinterpret_cast<const float4*>(ring + (a - red_a));
      } else {
        v = ld_cluster_f4(a, 0);
#pragma unroll
        for (int s = 1; s < S; ++s) {
          const float4 o = ld_cluster_f4(a, s);
          v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
        }
      }
      __nv_bfloat16* out = y + (size_t)m * N + n;
      if (vec && n + 3 < N) {
        const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + n));
        uint2 p;
        p.x = pack16<__nv_bfloat16>(v.x * sc.x, v.y * sc.y);
        p.y = pack16<__nv_bfloat16>(v.z * sc.z, v.w * sc.w);
        *reinterpret_cast<uint2*>(out) = p;
      } else {
        const float vs[4] = {v.x, v.y, v.z, v.w};
        for (int e = 0; e < 4 && n + e < N; ++e) out[e] = __float2bfloat16(vs[e] * scale[n + e]);
      }
    }
  }
  if (S > 1) {
    __syncwarp();
    cluster_sync();  // no block leaves while another reads its tile
  }
}

// [rows, cols] row-major as a 2-D map with boxes of (box_cols, box_rows) and
// the 128-byte swizzle; reads past either edge fill with zeros.
inline cudaError_t map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                          int esize, int rows, int cols, int box_rows, int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn || (reinterpret_cast<uintptr_t>(base) & 15)) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int C, int BT, int S>
cudaError_t launch_prefill(const void* x, const void* wq, const void* scale, void* y, int M,
                           int N, int K, cudaStream_t stream) {
  using P = Prefill<C, BT, S>;
  CUtensorMap tx, tw;
  cudaError_t err;
  if ((err = map_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, BT, 64)) != cudaSuccess)
    return err;
  if ((err = map_2d(&tw, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, P::kBN, kKT)) != cudaSuccess)
    return err;
  auto kernel = wgmma_kernel<C, BT, S>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + P::kBN - 1) / P::kBN, (M + BT - 1) / BT, S);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  if (S == 1) {
    kernel<<<grid, P::kThreads, P::kSmem, stream>>>(tx, tw, sc, yp, M, N, K);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(P::kThreads);
  cfg.dynamicSmemBytes = P::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = S;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, tx, tw, sc, yp, M, N, K);
}

// The prefill's tiles by shape. M > 128: two consumers x 128 tokens. M <=
// 128: one consumer and the smallest token tile that holds M, K split in 2
// or 4 while the split grid still has no more blocks than SMs (132) and
// every split keeps at least two K tiles. Splitting further costs more than
// it streams: at N = 4096 two splits (128 blocks) ran 16-25% faster than
// four, at N = 11008 none (172 blocks) 12-17% faster than two (PERF.md).
inline int prefill_splits(int M, int N, int K) {
  const int ktiles = (K + kKT - 1) / kKT;
  const long long blocks = (long long)((N + 63) / 64) * ((M + 127) / 128);
  int s = 1;
  while (s < 4 && blocks * 2 * s <= 132 && ktiles >= 4 * s) s *= 2;
  return s;
}

template <int BT>
cudaError_t launch_prefill_split(const void* x, const void* wq, const void* scale, void* y,
                                 int M, int N, int K, cudaStream_t stream) {
  switch (prefill_splits(M, N, K)) {
    case 1: return launch_prefill<1, BT, 1>(x, wq, scale, y, M, N, K, stream);
    case 2: return launch_prefill<1, BT, 2>(x, wq, scale, y, M, N, K, stream);
    default: return launch_prefill<1, BT, 4>(x, wq, scale, y, M, N, K, stream);
  }
}

cudaError_t dispatch_prefill(const void* x, const void* wq, const void* scale, void* y, int M,
                             int N, int K, cudaStream_t stream) {
  if (M > 128) return launch_prefill<2, 128, 1>(x, wq, scale, y, M, N, K, stream);
  if (M > 64) return launch_prefill_split<128>(x, wq, scale, y, M, N, K, stream);
  if (M > 32) return launch_prefill_split<64>(x, wq, scale, y, M, N, K, stream);
  if (M > 16) return launch_prefill_split<32>(x, wq, scale, y, M, N, K, stream);
  return launch_prefill_split<16>(x, wq, scale, y, M, N, K, stream);
}

cudaError_t launch_gemv_mma(const void* x, const void* wq, const void* scale, void* y, int M,
                            int N, int K, cudaStream_t stream) {
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wq);
  const float* sp = static_cast<const float*>(scale);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  // 32 channels a block where that still gives two blocks an SM, else 16
  // channels and twice the warps, each over fewer chunks of K
  if (N >= kMmaWideMinN)
    gemv_mma_kernel<2, kMmaWarpsWide, kMmaChunksWide>
        <<<(N + 31) / 32, kMmaWarpsWide * 32, 0, stream>>>(xp, wp, sp, yp, M, N, K);
  else
    gemv_mma_kernel<1, kMmaWarpsNarrow, kMmaChunksNarrow><<<(N + 15) / 16, kMmaWarpsNarrow * 32, 0, stream>>>(
        xp, wp, sp, yp, M, N, K);
  return cudaGetLastError();
}

template <typename T, int M>
void launch_gemv(const void* x, const void* wq, const void* scale, void* y, int N, int K,
                 cudaStream_t stream) {
  const int per_block = kWarps * kRows;
  gemv_kernel<T, M><<<(N + per_block - 1) / per_block, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<T*>(y), N, K);
}

// The f32 path on the SIMT designs: gemv_warp up to M = 8, tiled_simt above.
void dispatch_simt_f32(const void* x, const void* wq, const void* scale, void* y, int M, int N,
                       int K, cudaStream_t stream) {
  switch (M) {
    case 1: launch_gemv<float, 1>(x, wq, scale, y, N, K, stream); return;
    case 2: launch_gemv<float, 2>(x, wq, scale, y, N, K, stream); return;
    case 3: launch_gemv<float, 3>(x, wq, scale, y, N, K, stream); return;
    case 4: launch_gemv<float, 4>(x, wq, scale, y, N, K, stream); return;
    case 5: launch_gemv<float, 5>(x, wq, scale, y, N, K, stream); return;
    case 6: launch_gemv<float, 6>(x, wq, scale, y, N, K, stream); return;
    case 7: launch_gemv<float, 7>(x, wq, scale, y, N, K, stream); return;
    case 8: launch_gemv<float, 8>(x, wq, scale, y, N, K, stream); return;
    default: break;
  }
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  tiled_kernel<float><<<grid, kTiledThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(y), M, N, K);
}

// The design of a call: the rule of ops/int8_matmul.py design_for.
Design design_for(int M, int is_bf16) {
  if (!is_bf16) return M <= kGemvMaxM ? kGemvWarp : kTiledSimt;
  if (M > kGemvMaxM) return kSm90WgmmaTma;
  return M >= kMmaMinM ? kGemvMma : kGemvWarp;
}

}  // namespace fedml_int8

using namespace fedml_int8;

static unsigned long long h_launches[kDesigns];

// y = x . wq^T * scale on `stream`. Returns the launch's cudaError_t (0 on
// success); a shape it does not take returns cudaErrorInvalidValue.
extern "C" int fedml_int8_gemm(const void* x, const void* wq, const void* scale, void* y,
                               int M, int N, int K, int is_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Design design = design_for(M, is_bf16);
  cudaError_t err;
  switch (design) {
    case kGemvMma: err = launch_gemv_mma(x, wq, scale, y, M, N, K, s); break;
    case kSm90WgmmaTma: err = dispatch_prefill(x, wq, scale, y, M, N, K, s); break;
    default:  // the SIMT designs: all of f32, and bf16 at M = 1 (gemv_warp)
      if (is_bf16) launch_gemv<__nv_bfloat16, 1>(x, wq, scale, y, N, K, s);
      else dispatch_simt_f32(x, wq, scale, y, M, N, K, s);
      err = cudaGetLastError();
  }
  if (err == cudaSuccess) ++h_launches[design];
  return (int)err;
}

// Successful launches of `design` (enum Design: kGemvWarp 0, kTiledSimt 1,
// kGemvMma 2, kSm90WgmmaTma 3) since the library was loaded.
extern "C" long long fedml_int8_gemm_launches(int design) {
  if (design < 0 || design >= kDesigns) return -1;
  return (long long)h_launches[design];
}
