// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: fedml_tpu/ops/flash_attention.py:180 _fwd_kernel, launched by
// _fwd_impl at :244 with pl.pallas_call.
//
// Computes, per query row, s = (q.k^T) * D^-1/2 in f32, causal mask by
// global row/column (fill -1e30), an online softmax (running max m, sum l,
// rescaled accumulator), p cast to the input dtype for P.V with f32
// accumulation, and writes O = acc / l in the input dtype and
// lse = m + log(l) in f32. k tiles past the diagonal are skipped.
//
// What bounds it on the H100: causal forward at B=2, H=32, T=2048, D=128 is
// about 68.7 GFLOP against 134 MB of q/k/v/o, so the work is bound by
// operations (0.069 ms at the bf16 tensor-core peak of 989 TFLOP/s, against
// 0.040 ms for the bytes at 3.35 TB/s).
//
// What this design does about it: it is the simple, correct first kernel.
// One block of 256 threads per (head, 64-row q tile) keeps its q tile in
// shared memory as f32, streams K/V tiles of its KV head through shared
// memory, and does both products with f32 FMAs from shared memory. It runs
// on the FP32 pipe (67 TFLOP/s peak), not the tensor cores, and each FMA
// costs about half a shared-memory load, so it sits far from the bound;
// mma/wgmma tiles with TMA-fed K/V are the next step. The [T, T] scores never
// reach device memory, GQA reads each KV head in place, and causal k tiles
// past the diagonal are never loaded, which halves the work as on the TPU.
#include "flash_common.cuh"

namespace fedml_flash {

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  float* sq = smem;                 // [BQ][D+1]
  float* sk = sq + BQ * (D + 1);    // [BK][D+1]
  float* sv = sk + BK * (D + 1);    // [BK][D+1]
  float* sp = sv + BK * (D + 1);    // [BQ][BK+1] p in the input dtype's values

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
  const T* kh = static_cast<const T*>(a.k) + (size_t)bkv * t * D;
  const T* vh = static_cast<const T*>(a.v) + (size_t)bkv * t * D;

  load_tile<T, BQ, D>(sq, qh, q0, t);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = num_k_tiles<BQ, BK>(q0, t, a.causal);
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's readers of sk/sv/sp are done
    load_tile<T, BK, D>(sk, kh, k0, t);
    load_tile<T, BK, D>(sv, vh, k0, t);
    __syncthreads();

    float s[RI][CJ];
    tile_dot_nt<BQ, BK, D>(s, sq, sk);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 32 * j;
        const bool ok = col < t && (!a.causal || col <= row);
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 32 * j;
        const bool ok = col < t && (!a.causal || col <= row);
        const float p = ok ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        sp[(ty + 8 * i) * (BK + 1) + tx + 32 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    tile_acc_nn<BQ, BK, D>(acc, sp, sv);
  }

  T* oh = static_cast<T*>(a.o) + (size_t)bh * t * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= t) continue;
    const float l_safe = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) oh[(size_t)row * D + tx + 32 * j] = from_f32<T>(acc[i][j] / l_safe);
    if (tx == 0) a.lse_out[(size_t)bh * t + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D, int BQ, int BK>
struct FwdLaunch {
  static cudaError_t run(const FlashArgs& a, int bhq, cudaStream_t stream) {
    const size_t smem = sizeof(float) * ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
    auto kernel = flash_fwd_kernel<T, D, BQ, BK>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.t + BQ - 1) / BQ, bhq);
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace fedml_flash

// q, k, v: [bhq or bhkv, t, d] in bf16 (is_bf16) or f32; o like q; lse
// [bhq, t] f32. Returns a cudaError_t (0 on success).
extern "C" int fedml_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                               int bhq, int hq, int hkv, int t, int d, int causal, int block_q,
                               int block_k, int is_bf16, void* stream) {
  fedml_flash::FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse_out = lse;
  a.hq = hq;
  a.hkv = hkv;
  a.t = t;
  a.causal = causal;
  a.scale = 1.0f / sqrtf((float)d);
  return fedml_flash::dispatch<fedml_flash::FwdLaunch>(a, bhq, d, block_q, block_k, is_bf16,
                                                       static_cast<cudaStream_t>(stream));
}
