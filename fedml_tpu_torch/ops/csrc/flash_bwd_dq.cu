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
// What the bf16 design does about it: all three products run on the tensor
// cores as wgmma, fed by TMA. One block per (query head, 128-row q tile) has
// three warpgroups; heads run along blockIdx.x, so the query heads of one
// GQA group run side by side and share their K/V tiles in L2, and causal q
// tiles are taken highest first, since they visit the most k tiles. The
// producer (24 registers, setmaxnreg) loads the tile's Q and dO once, then
// streams the 128-row K and V tiles of the KV head through a two-stage ring
// of 128-byte-swizzled bf16 tiles (128-row k tiles measured 1-6% faster than
// 64-row ones, with no spills either way). Each of two
// consumer warpgroups (240 registers) owns 64 q rows and holds their lse,
// delta and dQ accumulator in registers. Per k tile, S = Q.K^T and dP = dO.V^T
// run from shared memory (both K-major) as two groups, so that
// p = exp2(s * scale * log2 e - lse * log2 e) is taken while dP runs; dS,
// rounded to bf16 in registers, is then the A operand of dQ += dS.K with K
// read MN-major through the transpose bit. Masks are applied only on tiles
// that cross the diagonal or T.
//
// The f32 instances keep the SIMT kernel of the first port (f32 FMAs from
// shared memory): tensor cores would need TF32, which misses the f32 gate.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace fedml_flash {

// --- f32: SIMT -----------------------------------------------------------------

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

// --- bf16: wgmma + TMA ---------------------------------------------------------

namespace sm90 {

template <int D, int BK>
struct DqTiles {
  static constexpr int kBQ = 128;     // two consumer warpgroups of 64 q rows
  static constexpr int kStages = 2;   // K/V ring depth
  static constexpr int kQElems = kBQ * D;
  static constexpr int kKElems = BK * D;
  static constexpr int kSmem =
      (2 * kQElems + 2 * kStages * kKElems) * 2 + (1 + 2 * kStages) * 8 + 1024;
};

template <int D, int BK>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo, FlashArgs a) {
  using L = DqTiles<D, BK>;
  constexpr int BQ = L::kBQ;
  constexpr int S = L::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(align_1024(smem_raw));
  __nv_bfloat16* sdo = sq + L::kQElems;
  __nv_bfloat16* sk = sdo + L::kQElems;     // [S] x tile
  __nv_bfloat16* sv = sk + S * L::kKElems;  // [S] x tile
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sv + S * L::kKElems);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + S;

  const int t = a.t;
  const int bh = blockIdx.x;  // heads along x: a GQA group's heads run side by side
  const int bkv = (bh / a.hq) * a.hkv + (bh % a.hq) / (a.hq / a.hkv);
  // causal: the high q tiles, which visit the most k tiles, start first
  const int q0 = (a.causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y) * BQ;
  const int nk = num_k_tiles<BQ, BK>(q0, t, a.causal);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load, Q and dO once, then the ring
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * L::kQElems * 2);
      tma_load_rows<D, BQ>(sq, &tq, bar_q, q0, bh);
      tma_load_rows<D, BQ>(sdo, &tdo, bar_q, q0, bh);
      for (int n = 0; n < nk; ++n) {
        const int st = n % S;
        mbar_wait(&empty[st], ((n / S) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * L::kKElems * 2);
        tma_load_rows<D, BK>(sk + st * L::kKElems, &tk, &full[st], n * BK, bkv);
        tma_load_rows<D, BK>(sv + st * L::kKElems, &tv, &full[st], n * BK, bkv);
      }
    }
  } else {
    regs_alloc<240>();
    const int c = wg - 1;  // q rows q0 + 64c .. q0 + 64c + 63
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int first_row = q0 + 64 * c;
    const int row0 = first_row + 16 * warp + lane / 4;  // and row0 + 8
    const __nv_bfloat16* sq_c = sq + 64 * c * 64;
    const __nv_bfloat16* sdo_c = sdo + 64 * c * 64;
    const float scale_log2 = a.scale * kLog2e;

    // the thread's two rows' lse (times log2 e) and delta; zeros past t
    float lse_log2[2], delta[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      lse_log2[h] = row < t ? a.lse[(size_t)bh * t + row] * kLog2e : 0.f;
      delta[h] = row < t ? a.delta[(size_t)bh * t + row] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int n = 0; n < nk; ++n) {
      const int st = n % S;
      const int k0 = n * BK;
      const __nv_bfloat16* k_st = sk + st * L::kKElems;
      const __nv_bfloat16* v_st = sv + st * L::kKElems;

      // S and dP in flight as two groups: p is built while dP runs
      float s[BK / 2], dp[BK / 2];
      mbar_wait(&full[st], (n / S) & 1);
      {
        const uint64_t q_desc = desc_k_major(sq_c);
        const uint64_t k_desc = desc_k_major(k_st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(s, k_step<BQ>(q_desc, kk), k_step<BK>(k_desc, kk), kk > 0);
        wgmma_commit();
      }
      {
        const uint64_t do_desc = desc_k_major(sdo_c);
        const uint64_t v_desc = desc_k_major(v_st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(dp, k_step<BQ>(do_desc, kk), k_step<BK>(v_desc, kk), kk > 0);
        wgmma_commit();
      }

      // element (q row, k column); a mask only past t or across the diagonal
      const bool masked = k0 + BK > t || (a.causal && k0 + BK - 1 > first_row);
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        s[i] = ex2(fmaf(s[i], scale_log2, -lse_log2[(i % 4) / 2]));
      if (masked) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int row = row0 + 8 * ((i % 4) / 2);
          const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          if (!(col < t && (!a.causal || col <= row))) s[i] = 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t dsa[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const float dl = delta[(i % 4) / 2];
        dsa[i / 8][(i % 8) / 2] = pack_bf16(s[i] * (dp[i] - dl), s[i + 1] * (dp[i + 1] - dl));
      }
      {
        const uint64_t k_desc = desc_mn_major<BK>(k_st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(dq, dsa[kk], mn_step(k_desc, kk), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    __nv_bfloat16* dqh = static_cast<__nv_bfloat16*>(a.dq) + (size_t)bh * t * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= t) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(dqh + (size_t)row * D + 8 * j + 2 * (lane % 4)) =
            __floats2bfloat162_rn(dq[i] * a.scale, dq[i + 1] * a.scale);
      }
    }
  }
}

template <int D, int BK>
cudaError_t dq_launch(const FlashArgs& a, int bhq, cudaStream_t stream) {
  using L = DqTiles<D, BK>;
  CUtensorMap tq, tk, tv, tdo;
  const int bhkv = bhq / a.hq * a.hkv;
  cudaError_t err;
  if ((err = rows_map(&tq, a.q, bhq, a.t, D, L::kBQ)) != cudaSuccess) return err;
  if ((err = rows_map(&tdo, a.dout, bhq, a.t, D, L::kBQ)) != cudaSuccess) return err;
  if ((err = rows_map(&tk, a.k, bhkv, a.t, D, BK)) != cudaSuccess) return err;
  if ((err = rows_map(&tv, a.v, bhkv, a.t, D, BK)) != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_kernel_sm90<D, BK>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhq, (a.t + L::kBQ - 1) / L::kBQ);
  kernel<<<grid, 384, L::kSmem, stream>>>(tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

// the compiled (block_q, block_k) pair; ops/flash_attention.py's TILES lists it
template <int D>
cudaError_t dq_dispatch(const FlashArgs& a, int bhq, int bq, int bk, cudaStream_t s) {
  if (bq == DqTiles<D, 128>::kBQ && bk == 128) return dq_launch<D, 128>(a, bhq, s);
  return cudaErrorInvalidValue;
}

}  // namespace sm90
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
  if (is_bf16)
    return counted(kSm90WgmmaTma, d == 64    ? sm90::dq_dispatch<64>(a, bhq, block_q, block_k, s)
                                  : d == 128 ? sm90::dq_dispatch<128>(a, bhq, block_q, block_k, s)
                                             : cudaErrorInvalidValue);
  return counted(kSimtF32Fma, dispatch_simt<DqLaunch, float>(a, bhq, d, block_q, block_k, s));
}

extern "C" long long fedml_flash_bwd_dq_launches(int design) {
  return fedml_flash::design_launches(design);
}
