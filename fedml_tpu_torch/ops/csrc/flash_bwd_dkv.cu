// Flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces: fedml_tpu/ops/flash_attention.py:305 _bwd_dkv_kernel, launched by
// _bwd_impl at :402 with pl.pallas_call.
//
// Computes, per KV head and k tile, over the q tiles from the causal start
// and over the G = Hq/Hkv query heads of the group: p = exp(s - lse),
// dV += p^T.dO, ds = p * (dO.V^T - delta), dK += ds^T.Q * D^-1/2, with p and
// ds cast to the input dtype before their products and the sums in f32.
//
// On the TPU the group is a sequential grid axis whose steps add into the
// same f32 output block. Blocks on the H100 run in no order, so here the
// group is a loop inside the block: one block per (KV head, k tile) walks
// every query head of its group and every q tile, keeps dK and dV in f32
// registers, and writes them once. No atomics, no second pass.
//
// What bounds it on the H100: at B=2, H=32, T=2048, D=128 causal it does four
// T x T x D products over the causal half, about 137 GFLOP, against about
// 168 MB of q/k/v/dO/dK/dV and the row stats: bound by operations (0.139 ms at
// 989 TFLOP/s bf16).
//
// What this design does about it: the simple, correct first kernel. K/V of
// the tile stay in shared memory as f32 while Q/dO tiles stream through;
// s and dp are built in registers with f32 FMAs, p and ds are staged in
// shared memory for the transposed products. It runs on the FP32 pipe, not
// the tensor cores; mma/wgmma tiles are the next step. Causal q tiles above
// the diagonal are never loaded.
#include "flash_common.cuh"

namespace fedml_flash {

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  float* sk = smem;                 // [BK][D+1]
  float* sv = sk + BK * (D + 1);    // [BK][D+1]
  float* sq = sv + BK * (D + 1);    // [BQ][D+1]
  float* sdo = sq + BQ * (D + 1);   // [BQ][D+1]
  float* sp = sdo + BQ * (D + 1);   // [BQ][BK+1]
  float* sds = sp + BQ * (BK + 1);  // [BQ][BK+1]

  constexpr int RI = BQ / 8;
  constexpr int CJ = BK / 32;
  constexpr int CI = BK / 8;
  constexpr int DJ = D / 32;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int t = a.t;
  const int bkv = blockIdx.y;
  const int group = a.hq / a.hkv;
  const int b = bkv / a.hkv;
  const int hk = bkv % a.hkv;
  const int k0 = blockIdx.x * BK;
  const T* kh = static_cast<const T*>(a.k) + (size_t)bkv * t * D;
  const T* vh = static_cast<const T*>(a.v) + (size_t)bkv * t * D;

  load_tile<T, BK, D>(sk, kh, k0, t);
  load_tile<T, BK, D>(sv, vh, k0, t);

  float dk[CI][DJ], dv[CI][DJ];
#pragma unroll
  for (int i = 0; i < CI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[i][j] = 0.f;
      dv[i][j] = 0.f;
    }

  const int nq = (t + BQ - 1) / BQ;
  // q tiles wholly above the diagonal see only masked entries
  const int start_q = a.causal ? k0 / BQ : 0;
  for (int g = 0; g < group; ++g) {
    const int bh = b * a.hq + hk * group + g;
    const T* qh = static_cast<const T*>(a.q) + (size_t)bh * t * D;
    const T* doh = static_cast<const T*>(a.dout) + (size_t)bh * t * D;
    for (int qb = start_q; qb < nq; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the previous tile's readers of sq/sdo/sp/sds are done
      load_tile<T, BQ, D>(sq, qh, q0, t);
      load_tile<T, BQ, D>(sdo, doh, q0, t);
      __syncthreads();

      float s[RI][CJ], dp[RI][CJ];
      tile_dot_nt<BQ, BK, D>(s, sq, sk);
      tile_dot_nt<BQ, BK, D>(dp, sdo, sv);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = q0 + ty + 8 * i;
        const float lse = row < t ? a.lse[(size_t)bh * t + row] : 0.f;
        const float delta = row < t ? a.delta[(size_t)bh * t + row] : 0.f;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int col = k0 + tx + 32 * j;
          const bool ok = row < t && col < t && (!a.causal || col <= row);
          const float p = ok ? expf(s[i][j] * a.scale - lse) : 0.f;
          const int at = (ty + 8 * i) * (BK + 1) + tx + 32 * j;
          sp[at] = round_to<T>(p);
          sds[at] = round_to<T>(p * (dp[i][j] - delta));
        }
      }
      __syncthreads();
      tile_acc_tn<BQ, BK, D>(dv, sp, sdo);
      tile_acc_tn<BQ, BK, D>(dk, sds, sq);
    }
  }

  T* dkh = static_cast<T*>(a.dk) + (size_t)bkv * t * D;
  T* dvh = static_cast<T*>(a.dv) + (size_t)bkv * t * D;
#pragma unroll
  for (int i = 0; i < CI; ++i) {
    const int row = k0 + ty + 8 * i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkh[(size_t)row * D + tx + 32 * j] = from_f32<T>(dk[i][j] * a.scale);
      dvh[(size_t)row * D + tx + 32 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

template <typename T, int D, int BQ, int BK>
struct DkvLaunch {
  static cudaError_t run(const FlashArgs& a, int bhkv, cudaStream_t stream) {
    const size_t smem = sizeof(float) * ((2 * BQ + 2 * BK) * (D + 1) + 2 * BQ * (BK + 1));
    auto kernel = flash_bwd_dkv_kernel<T, D, BQ, BK>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.t + BK - 1) / BK, bhkv);
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace fedml_flash

// q, dout: [bhkv / hkv * hq, t, d]; k, v, dk, dv: [bhkv, t, d]; lse, delta:
// [bhq, t] f32. Returns a cudaError_t (0 on success).
extern "C" int fedml_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, void* dk, void* dv,
                                   int bhkv, int hq, int hkv, int t, int d, int causal,
                                   int block_q, int block_k, int is_bf16, void* stream) {
  fedml_flash::FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  a.hq = hq;
  a.hkv = hkv;
  a.t = t;
  a.causal = causal;
  a.scale = 1.0f / sqrtf((float)d);
  return fedml_flash::dispatch<fedml_flash::DkvLaunch>(a, bhkv, d, block_q, block_k, is_bf16,
                                                       static_cast<cudaStream_t>(stream));
}
