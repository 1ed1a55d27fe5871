// Weight-only int8 GEMM: y[m, n] = cast(scale[n] * sum_k x[m, k] * float(wq[n, k])).
//
// Replaces: no TPU kernel. The JAX package computes this product outside any
// Pallas kernel, as lax.dot_general on the int8 operand with f32 accumulation
// (fedml_tpu/models/transformer.py:149-155, LoRALinear under
// weight_quant="int8"), and XLA widens the int8 operand inside its matmul
// pipeline. PyTorch has no mixed bf16 x s8 product: F.linear on a widened
// copy of the weights would write (and read back) a bf16 copy of every
// kernel on every decoded token, the copy that made the JAX package's int8
// decode 375x slower before it fed the int8 operand to the dot directly.
// This kernel reads the int8 weights once and widens them in registers.
//
// x [M, K] is bf16 or f32, wq [N, K] int8 row-major (torch's [out, in]
// layout), scale [N] f32, y [M, N] in x's dtype; accumulation in f32, the
// scale applied in f32 before the one cast of the result. K must be a
// multiple of 16 and every pointer 16-byte aligned (the wrapper checks).
//
// Bound. Decode (M <= 8) is bound by bytes: the N*K weight bytes dominate,
// at 3.35 TB/s on an H100 SXM. Design kGemvWarp: one warp computes ROWS
// output channels for all M rows; each lane loads 16 int8 of each channel
// with one 128-bit streaming load (evict-first: the weights are read once),
// widens them exactly with a byte permute and one f32 add (the 2^23 trick:
// the float whose mantissa holds b + 128, minus 2^23 + 128), and multiplies
// with f32 FMAs against x, which it reads through the read-only L1 path
// (every warp of an SM reads the same x rows). A warp-shuffle reduce ends
// each channel, then the scale. No shared memory, no block barrier.
//
// Prefill (larger M) is bound by operations at large M. Design kTiledSimt:
// a 64 x 64 output tile per block of 256 threads, 4 x 4 outputs a thread,
// K in steps of 16 through shared memory, the weights widened once as they
// are staged; f32 FMAs (the tensor cores, wgmma with the int8 operand
// widened into shared memory, wait for a later redesign).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fedml_int8 {

enum Design { kGemvWarp = 0, kTiledSimt = 1, kDesigns = 2 };

constexpr int kGemvMaxM = 8;
constexpr int kRows = 4;   // output channels a warp computes
constexpr int kWarps = 4;  // warps a block (gemv)

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

__device__ __forceinline__ void load_x4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(v.x << 16);
  out[1] = __uint_as_float(v.x & 0xFFFF0000u);
  out[2] = __uint_as_float(v.y << 16);
  out[3] = __uint_as_float(v.y & 0xFFFF0000u);
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

template <typename T, int M>
void launch_gemv(const void* x, const void* wq, const void* scale, void* y, int N, int K,
                 cudaStream_t stream) {
  const int per_block = kWarps * kRows;
  gemv_kernel<T, M><<<(N + per_block - 1) / per_block, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<T*>(y), N, K);
}

template <typename T>
void dispatch(const void* x, const void* wq, const void* scale, void* y, int M, int N, int K,
              cudaStream_t stream) {
  switch (M) {
    case 1: launch_gemv<T, 1>(x, wq, scale, y, N, K, stream); return;
    case 2: launch_gemv<T, 2>(x, wq, scale, y, N, K, stream); return;
    case 3: launch_gemv<T, 3>(x, wq, scale, y, N, K, stream); return;
    case 4: launch_gemv<T, 4>(x, wq, scale, y, N, K, stream); return;
    case 5: launch_gemv<T, 5>(x, wq, scale, y, N, K, stream); return;
    case 6: launch_gemv<T, 6>(x, wq, scale, y, N, K, stream); return;
    case 7: launch_gemv<T, 7>(x, wq, scale, y, N, K, stream); return;
    case 8: launch_gemv<T, 8>(x, wq, scale, y, N, K, stream); return;
    default: break;
  }
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  tiled_kernel<T><<<grid, kTiledThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<T*>(y), M, N, K);
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
  if (is_bf16) dispatch<__nv_bfloat16>(x, wq, scale, y, M, N, K, s);
  else dispatch<float>(x, wq, scale, y, M, N, K, s);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++h_launches[M <= kGemvMaxM ? kGemvWarp : kTiledSimt];
  return (int)err;
}

// Successful launches of `design` (kGemvWarp 0, kTiledSimt 1) since the
// library was loaded.
extern "C" long long fedml_int8_gemm_launches(int design) {
  if (design < 0 || design >= kDesigns) return -1;
  return (long long)h_launches[design];
}
