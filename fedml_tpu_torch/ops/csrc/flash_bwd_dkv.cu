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
// What the 16-bit design (bf16 and f16, one template) does about it: all
// four products run on the tensor cores as wgmma, fed by TMA. One block per (KV head, 128-row k tile) has
// three warpgroups; the low k tiles, which see the most causal q tiles,
// start first. The producer (24 registers, setmaxnreg) loads the K and V
// tiles once, then streams the 64-row Q and dO tiles of every (group head,
// q tile) through a two-stage ring of 128-byte-swizzled 16-bit tiles; the
// matching lse and delta rows land beside them by cp.async, completing on
// the same full barrier, so no global-load latency sits between a free stage
// and its refill. Each of two consumer warpgroups (240 registers) owns 64 k
// rows and holds its dK and dV accumulators in registers. The scores are
// built transposed, so that the k rows are the accumulator's rows:
// S^T = K.Q^T and dP^T = V.dO^T from shared memory (both K-major), issued as
// two groups so that p = exp2(s * scale * log2 e - lse * log2 e) is taken
// while dP^T runs; P^T and dS^T, rounded to the input type in registers,
// are then the
// A operands of dV += P^T.dO and dK += dS^T.Q, with dO and Q read MN-major
// through the transpose bit. Masks are applied only on tiles that cross the
// diagonal or T; causal q tiles above the diagonal are never loaded.
//
// Head dims: at the padded widths Dp = 64 and 128 each consumer owns 64 k
// rows. At Dp = 256 one consumer's dK and dV accumulators over all 256
// columns would take 256 registers a thread, so the two consumers share one
// 64-row k tile and each owns one 128-column half of dK and dV: both compute
// the tile's S^T and dP^T in full (over all of d), and each accumulates
// P^T.dO and dS^T.Q on its half of dO's and Q's columns. That repeats the
// two score products, 1.5 times the tensor work of the four products, and
// keeps a consumer's registers as at Dp = 128. A head dim below its padded
// width multiplies the zeros of the padding.
//
// The f32 instances keep the SIMT kernel of the first port (f32 FMAs from
// shared memory): tensor cores would need TF32, which misses the f32 gate.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace fedml_flash {

// --- f32: SIMT -----------------------------------------------------------------

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
  const int d = a.d;
  const int bkv = blockIdx.x;  // along x: B*Hkv may pass grid.y's 65,535
  const int group = a.hq / a.hkv;
  const int b = bkv / a.hkv;
  const int hk = bkv % a.hkv;
  const int k0 = blockIdx.y * BK;
  const T* kh = static_cast<const T*>(a.k) + (size_t)bkv * t * d;
  const T* vh = static_cast<const T*>(a.v) + (size_t)bkv * t * d;

  load_tile<T, BK, D>(sk, kh, k0, t, d);
  load_tile<T, BK, D>(sv, vh, k0, t, d);

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
    const T* qh = static_cast<const T*>(a.q) + (size_t)bh * t * d;
    const T* doh = static_cast<const T*>(a.dout) + (size_t)bh * t * d;
    for (int qb = start_q; qb < nq; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the previous tile's readers of sq/sdo/sp/sds are done
      load_tile<T, BQ, D>(sq, qh, q0, t, d);
      load_tile<T, BQ, D>(sdo, doh, q0, t, d);
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

  T* dkh = static_cast<T*>(a.dk) + (size_t)bkv * t * d;
  T* dvh = static_cast<T*>(a.dv) + (size_t)bkv * t * d;
#pragma unroll
  for (int i = 0; i < CI; ++i) {
    const int row = k0 + ty + 8 * i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      if (tx + 32 * j >= d) continue;
      dkh[(size_t)row * d + tx + 32 * j] = from_f32<T>(dk[i][j] * a.scale);
      dvh[(size_t)row * d + tx + 32 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

template <typename T, int D, int BQ, int BK>
struct DkvLaunch {
  static constexpr size_t kSmem =
      sizeof(float) * ((2 * BQ + 2 * BK) * (D + 1) + 2 * BQ * (BK + 1));
  static cudaError_t run(const FlashArgs& a, int bhkv, cudaStream_t stream) {
    auto kernel = flash_bwd_dkv_kernel<T, D, BQ, BK>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bhkv, (a.t + BK - 1) / BK);
    kernel<<<grid, kThreads, kSmem, stream>>>(a);
    return cudaGetLastError();
  }
};

// --- bf16 and f16: wgmma + TMA ------------------------------------------------

namespace sm90 {

// The tiles of the instance at padded width D.
template <int D>
struct DkvTiles {
  static constexpr int kSplit = D > 128 ? 2 : 1;  // consumers on one k row: column halves
  static constexpr int kBK = 128 / kSplit;        // k rows a block
  static constexpr int kDC = D / kSplit;          // dK and dV columns a consumer owns
  static constexpr int kBQ = 64;                  // q rows a stage
  static constexpr int kStages = 2;               // Q/dO ring depth
  static constexpr int kKElems = kBK * D;
  static constexpr int kQElems = kBQ * D;
  static constexpr int kSmem = (2 * kKElems + 2 * kStages * kQElems) * 2 +
                               kStages * 2 * kBQ * 4 + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kSmem <= (int)kMaxSmem, "dK/dV tiles exceed the shared memory");
};

template <typename E, int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo, FlashArgs a) {
  using L = DkvTiles<D>;
  constexpr int BK = L::kBK;
  constexpr int BQ = L::kBQ;
  constexpr int DC = L::kDC;
  constexpr int S = L::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  E* sk = reinterpret_cast<E*>(align_1024(smem_raw));
  E* sv = sk + L::kKElems;
  E* sq = sv + L::kKElems;        // [S] x tile
  E* sdo = sq + S * L::kQElems;   // [S] x tile
  float* stats = reinterpret_cast<float*>(sdo + S * L::kQElems);  // [S][lse, delta][BQ]
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(stats + S * 2 * BQ);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + S;

  const int t = a.t;
  const int bkv = blockIdx.x;  // heads along x: block ids take the low k tiles first
  const int group = a.hq / a.hkv;
  const int b = bkv / a.hkv;
  const int hk = bkv % a.hkv;
  const int k0 = blockIdx.y * BK;  // low k tiles have the most causal q tiles
  const int nq = (t + BQ - 1) / BQ;
  // q tiles wholly above the diagonal see only masked entries
  const int start_q = a.causal ? k0 / BQ : 0;
  const int per_head = nq - start_q;
  const int total = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA arrival and one per lane's stats copies
      mbar_init(&empty[s], 8);      // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: warp 0 streams the tiles, lane 0 issues the TMA loads
    regs_dealloc<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * L::kKElems * 2);
        tma_load_rows<D, BK>(sk, &tk, bar_kv, k0, bkv);
        tma_load_rows<D, BK>(sv, &tv, bar_kv, k0, bkv);
      }
      for (int n = 0; n < total; ++n) {
        const int st = n % S;
        const int bh = b * a.hq + hk * group + n / per_head;
        const int q0 = (start_q + n % per_head) * BQ;
        mbar_wait(&empty[st], ((n / S) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * L::kQElems * 2);
          tma_load_rows<D, BQ>(sq + st * L::kQElems, &tq, &full[st], q0, bh);
          tma_load_rows<D, BQ>(sdo + st * L::kQElems, &tdo, &full[st], q0, bh);
        }
        // the rows' lse and delta (zeros past t) land asynchronously too
#pragma unroll
        for (int i = lane; i < BQ; i += 32) {
          const int row = q0 + i;
          const size_t at = (size_t)bh * t + (row < t ? row : t - 1);
          cp_async_4(&stats[(st * 2) * BQ + i], a.lse + at, row < t);
          cp_async_4(&stats[(st * 2 + 1) * BQ + i], a.delta + at, row < t);
        }
        cp_async_arrive(&full[st]);
      }
    }
  } else {
    regs_alloc<240>();
    const int c = wg - 1;
    // k rows k0 + row_off .. + 63, dK/dV columns col_off .. col_off + DC - 1
    const int row_off = L::kSplit == 1 ? 64 * c : 0;
    const int col_off = L::kSplit == 1 ? 0 : DC * c;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int krow0 = k0 + row_off + 16 * warp + lane / 4;  // and krow0 + 8
    const E* sk_c = sk + row_off * 64;
    const E* sv_c = sv + row_off * 64;
    const float scale_log2 = a.scale * kLog2e;

    float dk[DC / 2], dv[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }

    mbar_wait(bar_kv, 0);
    for (int n = 0; n < total; ++n) {
      const int st = n % S;
      const int q0 = (start_q + n % per_head) * BQ;
      const E* q_st = sq + st * L::kQElems;
      const E* do_st = sdo + st * L::kQElems;
      const float* lse = stats + (st * 2) * BQ;
      const float* delta = lse + BQ;

      // S^T and dP^T in flight as two groups: p is built while dP^T runs
      float s[BQ / 2], dp[BQ / 2];
      mbar_wait(&full[st], (n / S) & 1);
      {
        const uint64_t k_desc = desc_k_major(sk_c);
        const uint64_t q_desc = desc_k_major(q_st);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_ss<E, BQ>(s, k_step<BK>(k_desc, k), k_step<BQ>(q_desc, k), k > 0);
        wgmma_commit();
      }
      {
        const uint64_t v_desc = desc_k_major(sv_c);
        const uint64_t do_desc = desc_k_major(do_st);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_ss<E, BQ>(dp, k_step<BK>(v_desc, k), k_step<BQ>(do_desc, k), k > 0);
        wgmma_commit();
      }

      // element (k row, q column); a mask only past t or across the diagonal
      const bool masked = q0 + BQ > t || (a.causal && q0 < k0 + row_off + 64);
      wgmma_wait<1>();
      fence_regs(s);
      float lse_log2[BQ / 4];  // [i]: the thread's q column 8(i/2) + 2(lane%4) + i%2
#pragma unroll
      for (int i = 0; i < BQ / 4; ++i)
        lse_log2[i] = lse[8 * (i / 2) + 2 * (lane % 4) + i % 2] * kLog2e;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        s[i] = ex2(fmaf(s[i], scale_log2, -lse_log2[2 * (i / 4) + i % 2]));
      if (masked) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int krow = krow0 + 8 * ((i % 4) / 2);
          const int col = q0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          if (!(col < t && (!a.causal || krow <= col))) s[i] = 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int i = 0; i < BQ / 2; i += 2) {
        const int j = 8 * (i / 4) + 2 * (lane % 4);
        pa[i / 8][(i % 8) / 2] = pack16<E>(s[i], s[i + 1]);
        dsa[i / 8][(i % 8) / 2] = pack16<E>(s[i] * (dp[i] - delta[j]),
                                            s[i + 1] * (dp[i + 1] - delta[j + 1]));
      }
      {
        // this consumer's columns of dO and Q: sub-tiles col_off / 64 on
        const uint64_t do_desc = desc_mn_major<BQ>(do_st + col_off * BQ);
        const uint64_t q_desc = desc_mn_major<BQ>(q_st + col_off * BQ);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BQ / 16; ++k) wgmma_rs<E, DC>(dv, pa[k], mn_step(do_desc, k), 1);
#pragma unroll
        for (int k = 0; k < BQ / 16; ++k) wgmma_rs<E, DC>(dk, dsa[k], mn_step(q_desc, k), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    E* dkh = static_cast<E*>(a.dk) + (size_t)bkv * t * a.d;
    E* dvh = static_cast<E*>(a.dv) + (size_t)bkv * t * a.d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = krow0 + 8 * h;
      if (row >= t) continue;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        const int col = col_off + 8 * j + 2 * (lane % 4);
        if (col >= a.d) continue;
        const size_t at = (size_t)row * a.d + col;
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(dkh + at) = pack16<E>(dk[i] * a.scale, dk[i + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvh + at) = pack16<E>(dv[i], dv[i + 1]);
      }
    }
  }
}

template <typename E, int D>
cudaError_t dkv_launch(const FlashArgs& a, int bhkv, cudaStream_t stream) {
  using L = DkvTiles<D>;
  CUtensorMap tq, tk, tv, tdo;
  const int bhq = bhkv / a.hkv * a.hq;
  cudaError_t err;
  if ((err = rows_map<E>(&tq, a.q, bhq, a.t, a.d, L::kBQ)) != cudaSuccess) return err;
  if ((err = rows_map<E>(&tdo, a.dout, bhq, a.t, a.d, L::kBQ)) != cudaSuccess) return err;
  if ((err = rows_map<E>(&tk, a.k, bhkv, a.t, a.d, L::kBK)) != cudaSuccess) return err;
  if ((err = rows_map<E>(&tv, a.v, bhkv, a.t, a.d, L::kBK)) != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_kernel_sm90<E, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhkv, (a.t + L::kBK - 1) / L::kBK);
  kernel<<<grid, 384, L::kSmem, stream>>>(tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

// the instance at a.d's padded width, if (bq, bk) is its one compiled pair;
// ops/flash_attention.py's TILES lists them
template <typename E, int D>
cudaError_t dkv_tiles(const FlashArgs& a, int bhkv, int bq, int bk, cudaStream_t s) {
  if (bq == DkvTiles<D>::kBQ && bk == DkvTiles<D>::kBK) return dkv_launch<E, D>(a, bhkv, s);
  return cudaErrorInvalidValue;
}

template <typename E>
cudaError_t dkv_dispatch(const FlashArgs& a, int bhkv, int bq, int bk, cudaStream_t s) {
  switch (padded_width(a.d)) {
    case 64: return dkv_tiles<E, 64>(a, bhkv, bq, bk, s);
    case 128: return dkv_tiles<E, 128>(a, bhkv, bq, bk, s);
    case 256: return dkv_tiles<E, 256>(a, bhkv, bq, bk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace fedml_flash

// q, dout: [bhkv / hkv * hq, t, d]; k, v, dk, dv: [bhkv, t, d], all f32, bf16
// or f16 (dtype: DtypeCode); lse, delta: [bhq, t] f32. Returns a cudaError_t
// (0 on success).
extern "C" int fedml_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, void* dk, void* dv,
                                   int bhkv, int hq, int hkv, int t, int d, int causal,
                                   int block_q, int block_k, int dtype, void* stream) {
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
  a.d = d;
  a.causal = causal;
  a.scale = 1.0f / sqrtf((float)d);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace fedml_flash;
  switch (dtype) {
    case kBf16:
      return counted(kSm90WgmmaTma, sm90::dkv_dispatch<__nv_bfloat16>(a, bhkv, block_q, block_k, s));
    case kF16:
      return counted(kSm90WgmmaTma, sm90::dkv_dispatch<__half>(a, bhkv, block_q, block_k, s));
    case kF32:
      return counted(kSimtF32Fma, dispatch_simt<DkvLaunch, float>(a, bhkv, block_q, block_k, s));
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" long long fedml_flash_bwd_dkv_launches(int design) {
  return fedml_flash::design_launches(design);
}
