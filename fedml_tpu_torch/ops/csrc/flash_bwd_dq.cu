// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: fedml_tpu/ops/flash_attention.py:273 _bwd_dq_kernel, launched by
// _bwd_impl at :376 with pl.pallas_call.
//
// Computes, per query row, p = exp(s - lse) from the saved logsumexp,
// dp = dO.V^T, ds = p * (dp - delta) with delta = rowsum(dO * O), and
// dQ = sum over k tiles of ds.K * D^-1/2, ds cast to the input dtype before
// the product and the sum kept in f32. Causal k tiles past the diagonal are
// skipped, the same visit set as the forward.
//
// What bounds it on the H100: at B=2, H=32, T=2048, D=128 causal it does
// three T x T x D products over the causal half, about 103 GFLOP, against
// about 168 MB of q/k/v/dO/dQ and the row stats: bound by operations
// (0.104 ms at 989 TFLOP/s bf16).
//
// What this design does about it: the simple, correct first kernel. One
// block of 256 threads per (head, q tile) holds its q and dO tiles in shared
// memory as f32, streams K/V tiles of its KV head, builds s and dp in
// registers with f32 FMAs, stages ds in shared memory and accumulates dQ in
// registers, so the [T, T] matrices never reach device memory and no atomics
// are needed. It runs on the FP32 pipe, not the tensor cores; mma/wgmma
// tiles are the next step.
#include "flash_common.cuh"

namespace fedml_flash {

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  float* sq = smem;                 // [BQ][D+1]
  float* sdo = sq + BQ * (D + 1);   // [BQ][D+1]
  float* sk = sdo + BQ * (D + 1);   // [BK][D+1]
  float* sv = sk + BK * (D + 1);    // [BK][D+1]
  float* sds = sv + BK * (D + 1);   // [BQ][BK+1]

  constexpr int RI = BQ / 8;
  constexpr int CJ = BK / 32;
  constexpr int DJ = D / 32;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int t = a.t;
  const int bh = blockIdx.y;
  const int group = a.hq / a.hkv;
  const int bkv = (bh / a.hq) * a.hkv + (bh % a.hq) / group;
  const int q0 = blockIdx.x * BQ;
  const T* qh = static_cast<const T*>(a.q) + (size_t)bh * t * D;
  const T* doh = static_cast<const T*>(a.dout) + (size_t)bh * t * D;
  const T* kh = static_cast<const T*>(a.k) + (size_t)bkv * t * D;
  const T* vh = static_cast<const T*>(a.v) + (size_t)bkv * t * D;

  load_tile<T, BQ, D>(sq, qh, q0, t);
  load_tile<T, BQ, D>(sdo, doh, q0, t);

  float lse[RI], delta[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 8 * i;
    lse[i] = row < t ? a.lse[(size_t)bh * t + row] : 0.f;
    delta[i] = row < t ? a.delta[(size_t)bh * t + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = num_k_tiles<BQ, BK>(q0, t, a.causal);
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's readers of sk/sv/sds are done
    load_tile<T, BK, D>(sk, kh, k0, t);
    load_tile<T, BK, D>(sv, vh, k0, t);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
    tile_dot_nt<BQ, BK, D>(s, sq, sk);
    tile_dot_nt<BQ, BK, D>(dp, sdo, sv);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 32 * j;
        const bool ok = row < t && col < t && (!a.causal || col <= row);
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        sds[(ty + 8 * i) * (BK + 1) + tx + 32 * j] = round_to<T>(p * (dp[i][j] - delta[i]));
      }
    }
    __syncthreads();
    tile_acc_nn<BQ, BK, D>(acc, sds, sk);
  }

  T* dqh = static_cast<T*>(a.dq) + (size_t)bh * t * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqh[(size_t)row * D + tx + 32 * j] = from_f32<T>(acc[i][j] * a.scale);
  }
}

template <typename T, int D, int BQ, int BK>
struct DqLaunch {
  static cudaError_t run(const FlashArgs& a, int bhq, cudaStream_t stream) {
    const size_t smem = sizeof(float) * ((2 * BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
    auto kernel = flash_bwd_dq_kernel<T, D, BQ, BK>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.t + BQ - 1) / BQ, bhq);
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace fedml_flash

// q, dout, dq: [bhq, t, d]; k, v: [bhq / hq * hkv, t, d]; lse, delta: [bhq, t]
// f32. Returns a cudaError_t (0 on success).
extern "C" int fedml_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dq, int bhq, int hq,
                                  int hkv, int t, int d, int causal, int block_q, int block_k,
                                  int is_bf16, void* stream) {
  fedml_flash::FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.hq = hq;
  a.hkv = hkv;
  a.t = t;
  a.causal = causal;
  a.scale = 1.0f / sqrtf((float)d);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace fedml_flash;
  return counted(kSimtF32Fma,
                 is_bf16 ? dispatch_simt<DqLaunch, __nv_bfloat16>(a, bhq, d, block_q, block_k, s)
                         : dispatch_simt<DqLaunch, float>(a, bhq, d, block_q, block_k, s));
}

extern "C" long long fedml_flash_bwd_dq_launches(int design) {
  return fedml_flash::design_launches(design);
}
