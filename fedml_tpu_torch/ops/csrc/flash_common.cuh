// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): the arguments, and the SIMT kernels'
// tiles (all three in f32; in bf16 all three are wgmma kernels built from
// flash_sm90.cuh).
//
// Layout: q and dO are [B*Hq, T, D], k and v [B*Hkv, T, D], all contiguous,
// lse and delta [B*Hq, T] f32. Query head h of batch b reads KV head
// h / (Hq/Hkv) of the same batch; K and V are never repeated.
//
// Every SIMT kernel runs 256 threads (8 warps). A tile of rows is staged in
// shared memory as f32 with a row stride of D+1 floats, so that 32 lanes
// reading one column of 32 different rows hit 32 different banks. Score
// tiles [R][C] are spread over the block as rows ty + 8*i and columns
// tx + 32*j (ty = warp, tx = lane): one warp owns whole rows, so a row's
// max and sum are warp shuffles and never touch shared memory.
//
// This file has a plain C interface and includes no PyTorch header.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fedml_flash {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the mask fill of the JAX kernels

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;   // backward only
  const float* lse;   // read by the backward, written by the forward
  const float* delta; // backward only: rowsum(dO * O)
  void* o;            // forward output
  float* lse_out;     // forward output
  void* dq;
  void* dk;
  void* dv;
  int hq;
  int hkv;
  int t;
  int causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The value a cast to the input type and back gives: the JAX kernels cast
// p and ds to the operand dtype before their second matmul.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// Stage rows [row0, row0 + R) of a [T, D] matrix as f32 rows of stride
// D + 1; rows at or past T read as zero.
template <typename T, int R, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int t) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < t ? to_f32(src[(size_t)g * D + c]) : 0.f;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s[i][j] = sum_d a[ty + 8i][d] * b[tx + 32j][d] over staged tiles a [RA][D+1]
// and b [RB][D+1] (the "nt" product q.k^T of the JAX kernels' _dot_nt).
template <int RA, int RB, int D>
__device__ __forceinline__ void tile_dot_nt(float (&s)[RA / 8][RB / 32], const float* a,
                                            const float* b) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < RA / 8; ++i)
#pragma unroll
    for (int j = 0; j < RB / 32; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float bv[RB / 32];
#pragma unroll
    for (int j = 0; j < RB / 32; ++j) bv[j] = b[(tx + 32 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < RA / 8; ++i) {
      const float av = a[(ty + 8 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < RB / 32; ++j) s[i][j] = fmaf(av, bv[j], s[i][j]);
    }
  }
}

// acc[i][j] += sum_c p[ty + 8i][c] * m[c][tx + 32j] for p [RA][RC+1] and
// m [RC][D+1] (P.V in the forward, dS.K in dQ).
template <int RA, int RC, int D>
__device__ __forceinline__ void tile_acc_nn(float (&acc)[RA / 8][D / 32], const float* p,
                                            const float* m) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll 4
  for (int c = 0; c < RC; ++c) {
    float mv[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) mv[j] = m[c * (D + 1) + tx + 32 * j];
#pragma unroll
    for (int i = 0; i < RA / 8; ++i) {
      const float pv = p[(ty + 8 * i) * (RC + 1) + c];
#pragma unroll
      for (int j = 0; j < D / 32; ++j) acc[i][j] = fmaf(pv, mv[j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum_r p[r][ty + 8i] * m[r][tx + 32j] for p [RR][RA+1] and
// m [RR][D+1] (P^T.dO and dS^T.Q in dK/dV).
template <int RR, int RA, int D>
__device__ __forceinline__ void tile_acc_tn(float (&acc)[RA / 8][D / 32], const float* p,
                                            const float* m) {
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll 4
  for (int r = 0; r < RR; ++r) {
    float mv[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) mv[j] = m[r * (D + 1) + tx + 32 * j];
#pragma unroll
    for (int i = 0; i < RA / 8; ++i) {
      const float pv = p[r * (RA + 1) + ty + 8 * i];
#pragma unroll
      for (int j = 0; j < D / 32; ++j) acc[i][j] = fmaf(pv, mv[j], acc[i][j]);
    }
  }
}

// Number of k tiles the q tile starting at row q0 must visit: all of them
// when dense, up to the one holding the tile's last row when causal (the
// JAX kernels' _causal_num_k).
template <int BQ, int BK>
__device__ __forceinline__ int num_k_tiles(int q0, int t, int causal) {
  const int n = (t + BK - 1) / BK;
  if (!causal) return n;
  const int c = (q0 + BQ + BK - 1) / BK;
  return c < n ? c : n;
}

// Runs L<T, D, BQ, BK>::run(a, stream) of a SIMT kernel for the runtime choice
// of head dim and tiles. A combination with no instance returns
// cudaErrorInvalidValue (the Python wrappers refuse those before they get
// here).
template <template <typename, int, int, int> class L, typename T, int D>
cudaError_t dispatch_tiles(const FlashArgs& a, int bh, int bq, int bk, cudaStream_t s) {
  if (bq == 64 && bk == 64) return L<T, D, 64, 64>::run(a, bh, s);
  if (bq == 64 && bk == 32) return L<T, D, 64, 32>::run(a, bh, s);
  if (bq == 32 && bk == 64) return L<T, D, 32, 64>::run(a, bh, s);
  if (bq == 32 && bk == 32) return L<T, D, 32, 32>::run(a, bh, s);
  return cudaErrorInvalidValue;
}

template <template <typename, int, int, int> class L, typename T>
cudaError_t dispatch_simt(const FlashArgs& a, int bh, int d, int bq, int bk, cudaStream_t s) {
  if (d == 64) return dispatch_tiles<L, T, 64>(a, bh, bq, bk, s);
  if (d == 128) return dispatch_tiles<L, T, 128>(a, bh, bq, bk, s);
  return cudaErrorInvalidValue;
}

// Successful launches of each design in this library, so a caller can tell
// which kernels ran; each source exports them as fedml_flash_*_launches
// (ops/_build.py DESIGNS names the indices). Internal linkage: an inline
// (vague-linkage) counter would be one object shared by all three libraries.
enum Design { kSimtF32Fma = 0, kSm90WgmmaTma = 1, kDesigns = 2 };
namespace {
long long g_design_launches[kDesigns] = {};

cudaError_t counted(Design design, cudaError_t err) {
  if (err == cudaSuccess) ++g_design_launches[design];
  return err;
}

long long design_launches(int design) {
  return design >= 0 && design < kDesigns ? g_design_launches[design] : -1;
}
}  // namespace

}  // namespace fedml_flash
