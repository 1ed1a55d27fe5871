// Flash-attention forward for Hopper (sm_90a).
//
// Replaces: fedml_tpu/ops/flash_attention.py:180 _fwd_kernel, launched by
// _fwd_impl at :244 with pl.pallas_call.
//
// Computes, per query row, s = (q.k^T) * D^-1/2 in f32, causal mask by
// global row/column (fill -1e30), an online softmax (running max m, sum l,
// rescaled accumulator), p cast to the input dtype for P.V with f32
// accumulation, and writes O = acc / max(l, 1e-20) in the input dtype and
// lse = m + log(l) in f32. k tiles past the diagonal are never loaded.
//
// What bounds it on the H100: causal forward at B=2, H=32, T=2048, D=128 is
// about 68.7 GFLOP against 134 MB of q/k/v/o, so the work is bound by
// operations (0.069 ms at the bf16 tensor-core peak of 989 TFLOP/s, against
// 0.040 ms for the bytes at 3.35 TB/s).
//
// What the 16-bit design (bf16 and f16, one template) does about it: both
// products run on the tensor cores as wgmma, fed by TMA, in a persistent,
// warp-specialised block of three
// warpgroups, one block per SM, that walks (query head, 128-row q tile) work
// tiles longest first. The producer (24 registers, setmaxnreg) loads each
// tile's Q into one of two buffers and streams the K/V tiles of its KV head
// through a two-stage ring of 128-byte-swizzled 16-bit tiles; K and V of a
// stage have their own full and empty mbarriers, so the next tile's Q and
// K/V load while the consumers finish the current one, and the next tile's
// first q.k^T runs under the current tile's epilogue. Each of two consumer
// warpgroups (240 registers) owns 64 q rows: S = Q.K^T is an m64nBKk16
// wgmma from shared memory; the softmax runs on the accumulator fragment (a
// row lives in a quad of lanes: max by two shuffles, the sum kept per lane
// and reduced once at the end); P, rounded to the input type in registers, is the A
// operand of O += P.V with V read MN-major through the transpose bit. S of k
// tile n and P.V of tile n-1 are issued together and the softmax of tile n
// runs while P.V does; the two consumers take turns to issue (named
// barriers), so one's softmax also runs under the other's products. The softmax, not the loads, bounded the first
// version of this design: per element it now costs one max, one FFMA, one
// ex2 and one add. GQA reads each KV head in place.
//
// Head dims: instances at the padded widths Dp = 64 and 128 run 128-row k
// tiles and two Q buffers; at Dp = 256 a 128-row S tile beside the 256-wide
// O accumulator would not fit a consumer's registers, nor two Q buffers and
// a ring of 128-row K/V tiles the shared memory, so Dp = 256 runs 64-row k
// tiles and one Q buffer (the next tile's Q loads once the current tile's
// last S is done): 64 KB of Q and 128 KB of K/V. A head dim below its padded
// width (d = 8 .. 56 at 64, 72 .. 120 at 128, 136 .. 248 at 256) multiplies
// the zeros of the padding: at d = 16 four times the products d needs, at
// d = 80 or 96 1.6 and 1.33 times.
//
// The f32 instances keep the SIMT kernel of the first port (f32 FMAs from
// shared memory): tensor cores would need TF32, which misses the f32 gate.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace fedml_flash {

// --- f32: SIMT -----------------------------------------------------------------

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
  const int d = a.d;
  const int bh = blockIdx.x;  // along x: B*Hq may pass grid.y's 65,535
  const int group = a.hq / a.hkv;
  const int bkv = (bh / a.hq) * a.hkv + (bh % a.hq) / group;
  const int q0 = blockIdx.y * BQ;
  const T* qh = static_cast<const T*>(a.q) + (size_t)bh * t * d;
  const T* kh = static_cast<const T*>(a.k) + (size_t)bkv * t * d;
  const T* vh = static_cast<const T*>(a.v) + (size_t)bkv * t * d;

  load_tile<T, BQ, D>(sq, qh, q0, t, d);

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
    load_tile<T, BK, D>(sk, kh, k0, t, d);
    load_tile<T, BK, D>(sv, vh, k0, t, d);
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

  T* oh = static_cast<T*>(a.o) + (size_t)bh * t * d;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= t) continue;
    const float l_safe = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (tx + 32 * j < d) oh[(size_t)row * d + tx + 32 * j] = from_f32<T>(acc[i][j] / l_safe);
    if (tx == 0) a.lse_out[(size_t)bh * t + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D, int BQ, int BK>
struct FwdLaunch {
  static constexpr size_t kSmem = sizeof(float) * ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
  static cudaError_t run(const FlashArgs& a, int bhq, cudaStream_t stream) {
    auto kernel = flash_fwd_kernel<T, D, BQ, BK>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bhq, (a.t + BQ - 1) / BQ);
    kernel<<<grid, kThreads, kSmem, stream>>>(a);
    return cudaGetLastError();
  }
};

// --- bf16 and f16: wgmma + TMA ------------------------------------------------

namespace sm90 {

// The tiles of the instance at padded width D.
template <int D>
struct FwdTiles {
  static constexpr int kBQ = 128;                 // two consumer warpgroups of 64 rows
  static constexpr int kBK = D > 128 ? 64 : 128;  // k rows a K/V stage
  static constexpr int kQBufs = D > 128 ? 1 : 2;  // Q buffers
  static constexpr int kStages = 2;               // K/V ring depth
  static constexpr int kQElems = kBQ * D;         // one Q buffer
  static constexpr int kKVElems = kBK * D;
  static constexpr int kSmem =
      (kQBufs * kQElems + 2 * kStages * kKVElems) * 2 + (4 + 4 * kStages) * 8 + 1024;
  static_assert(kSmem <= (int)kMaxSmem, "forward tiles exceed the shared memory");
};

// Where a consumer thread's two rows sit, for the mask and the scale.
struct SoftmaxRows {
  float scale_log2;  // d^-1/2 * log2(e)
  int row0;          // global row of d[4j], d[4j+1]; d[4j+2], d[4j+3] are row0 + 8
  int lane;
  int t;
  int causal;
  int first_row;     // the warpgroup's first row
};

// One online-softmax step on the S tile of columns k0 .. k0 + BK - 1 held
// as an m64nBK accumulator fragment of raw scores q.k. m is the running max
// of the raw scores (the scale is positive, so scale * m is the max of the
// scaled scores); masked entries (only in a tile past t or across the
// diagonal) become -inf, so their p is exactly 0. Sets corr, the factor that
// rescales the running sum (here) and the accumulator (by the caller), and
// p = 2^((s - m) * scale * log2 e) = exp(s * scale - m * scale) in place of
// s. l keeps each lane's part of the row sum. Per element: one max, one
// FFMA, one ex2 and one add.
template <int BK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const SoftmaxRows& r, int k0) {
  if (k0 + BK > r.t || (r.causal && k0 + BK - 1 > r.first_row)) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * (r.lane % 4) + (i % 2);
      if (!(col < r.t && (!r.causal || col <= r.row0 + 8 * ((i % 4) / 2)))) s[i] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
  float mb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = ex2((m[h] - mx[h]) * r.scale_log2);
    m[h] = mx[h];
    l[h] *= corr[h];
    mb[h] = m[h] * r.scale_log2;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = ex2(fmaf(s[i], r.scale_log2, -mb[(i % 4) / 2]));
    l[(i % 4) / 2] += s[i];
  }
}

// p rounded to E: the A fragment of P.V
template <typename E, int BK>
__device__ __forceinline__ void to_fragment(const float (&p)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) pa[i / 8][(i % 8) / 2] = pack16<E>(p[i], p[i + 1]);
}

// the accumulator's two rows times their corr, skipped by a warp whose
// rows' maxima all stayed put (corr == 1)
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&corr)[2]) {
  if (!__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= corr[(i % 4) / 2];
}

// The work tile a persistent block takes in its j-th turn: tiles are
// ordered longest first (causal: the last q tile of every head, then the one
// before, ...), and the blocks deal them out in a snake (block b takes
// b, 2G-1-b, 2G+b, ... for G blocks), so that every block's sum of k tiles
// stays near the mean.
struct FwdWork {
  int bh;   // query head row of [B*Hq]
  int bkv;  // its KV head row of [B*Hkv]
  int q0;   // first q row of the tile
  int nk;   // k tiles it visits
};

__device__ __forceinline__ int snake_item(int j) {
  const int g = gridDim.x;
  return j * g + (j % 2 ? g - 1 - blockIdx.x : blockIdx.x);
}

template <int BQ, int BK>
__device__ __forceinline__ FwdWork fwd_work(int item, int bhq, int nqt, const FlashArgs& a) {
  FwdWork w;
  w.bh = item % bhq;
  w.bkv = (w.bh / a.hq) * a.hkv + (w.bh % a.hq) / (a.hq / a.hkv);
  const int qt = item / bhq;
  w.q0 = (a.causal ? nqt - 1 - qt : qt) * BQ;
  w.nk = num_k_tiles<BQ, BK>(w.q0, a.t, a.causal);
  return w;
}

// S = Q.K^T of a consumer's 64 q rows and a k tile, issued as one group
template <typename E, int D, int BQ, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], const E* q, const E* k) {
  const uint64_t q_desc = desc_k_major(q);
  const uint64_t k_desc = desc_k_major(k);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<E, BK>(s, k_step<BQ>(q_desc, kk), k_step<BK>(k_desc, kk), kk > 0);
  wgmma_commit();
}

// O (+)= P.V for a v tile, issued as one group; a tile's first P.V
// overwrites O (accumulate false), so O is never zeroed by other
// instructions while a wgmma is in flight, which would make ptxas serialise
// every wgmma of the kernel
template <typename E, int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                         const E* v, bool accumulate) {
  const uint64_t v_desc = desc_mn_major<BK>(v);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<E, D>(o, pa[kk], mn_step(v_desc, kk), accumulate || kk > 0);
  wgmma_commit();
}

// The epilogue of a consumer's 64 rows: O = acc / l in E (columns below d,
// row stride d) and lse = scale * m + log(l), rows at or past t skipped
template <typename E, int D>
__device__ __forceinline__ void store_tile(const float (&o)[D / 2], const float (&m)[2],
                                           float (&l)[2], E* oh, float* lse, int row0, int lane,
                                           int t, int d, float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float l_safe = fmaxf(l[h], 1e-20f);
    const float inv_l = 1.f / l_safe;
    const int row = row0 + 8 * h;
    if (row < t) {
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + 2 * (lane % 4);  // even: col and col + 1 are both below d or not
        if (col < d)
          *reinterpret_cast<uint32_t*>(oh + (size_t)row * d + col) =
              pack16<E>(o[4 * jj + 2 * h] * inv_l, o[4 * jj + 2 * h + 1] * inv_l);
      }
      if (lane % 4 == 0) lse[row] = m[h] * scale + logf(l_safe);
    }
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, FlashArgs a, int bhq) {
  using L = FwdTiles<D>;
  constexpr int BQ = L::kBQ;
  constexpr int BK = L::kBK;
  constexpr int QB = L::kQBufs;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  E* sq = reinterpret_cast<E*>(align_1024(smem_raw));  // [QB] x tile
  E* sk = sq + QB * L::kQElems;                         // [S] x tile
  E* sv = sk + S * L::kKVElems;                         // [S] x tile
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sv + S * L::kKVElems);  // [QB]
  uint64_t* empty_q = full_q + 2;                                         // [QB]
  uint64_t* full_k = empty_q + 2;
  uint64_t* full_v = full_k + S;
  uint64_t* empty_k = full_v + S;  // K and V of a stage are released apart
  uint64_t* empty_v = empty_k + S;

  const int t = a.t;
  const int nqt = (t + BQ - 1) / BQ;
  const int tiles = bhq * nqt;

  if (threadIdx.x == 0) {
    for (int b = 0; b < QB; ++b) {
      mbar_init(&full_q[b], 1);
      mbar_init(&empty_q[b], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);
      mbar_init(&empty_v[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load. With two Q buffers a tile's Q
    // loads while the tile before it runs; with one, once that tile's last S
    // is done.
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int n = 0;  // K/V tiles through the ring so far
      for (int j = 0; snake_item(j) < tiles; ++j) {
        const FwdWork w = fwd_work<BQ, BK>(snake_item(j), bhq, nqt, a);
        mbar_wait(&empty_q[j % QB], ((j / QB) & 1) ^ 1);
        mbar_expect_tx(&full_q[j % QB], L::kQElems * 2);
        tma_load_rows<D, BQ>(sq + (j % QB) * L::kQElems, &tq, &full_q[j % QB], w.q0, w.bh);
        for (int kb = 0; kb < w.nk; ++kb, ++n) {
          const int st = n % S;
          const uint32_t free_parity = ((n / S) & 1) ^ 1;
          mbar_wait(&empty_k[st], free_parity);
          mbar_expect_tx(&full_k[st], L::kKVElems * 2);
          tma_load_rows<D, BK>(sk + st * L::kKVElems, &tk, &full_k[st], kb * BK, w.bkv);
          mbar_wait(&empty_v[st], free_parity);
          mbar_expect_tx(&full_v[st], L::kKVElems * 2);
          tma_load_rows<D, BK>(sv + st * L::kKVElems, &tv, &full_v[st], kb * BK, w.bkv);
        }
      }
    }
  } else {
    regs_alloc<240>();
    const int c = wg - 1;  // rows q0 + 64c .. q0 + 64c + 63 of each tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const float scale_log2 = a.scale * 1.4426950408889634f;
    // this consumer's rows of Q buffer b
    auto q_rows = [&](int b) { return sq + b * L::kQElems + 64 * c * 64; };

    // The two consumers take turns to issue their wgmmas (named barriers
    // 1 + c), so one's softmax runs while the other's products do;
    // consumer 0 goes first.
    const int turn = 1 + c;
    const int other_turn = 2 - c;
    if (c == 1) named_arrive(1, 256);

    float s[BK / 2];
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    int n = 0;  // K/V tiles through the ring so far
    // The first tile's first product; every later tile's is issued in the
    // last turn of the tile before it, so that it runs under that tile's
    // epilogue. Each is complete before its tile's iteration starts: a wgmma
    // in flight across the loop's back edge would have the compiler's moves
    // define its accumulator, and ptxas would serialise every wgmma.
    if (snake_item(0) < tiles) {
      mbar_wait(&full_q[0], 0);
      mbar_wait(&full_k[0], 0);
      named_sync(turn, 256);
      issue_qk<E, D, BQ, BK>(s, q_rows(0), sk);
      named_arrive(other_turn, 256);
      wgmma_wait<0>();
      fence_regs(s);
    }
    for (int j = 0; snake_item(j) < tiles; ++j) {
      const FwdWork w = fwd_work<BQ, BK>(snake_item(j), bhq, nqt, a);
      const E* sq_c = q_rows(j % QB);
      const int row0 = w.q0 + 64 * c + 16 * warp + lane / 4;  // and row0 + 8
      const SoftmaxRows rows{scale_log2, row0, lane, t, a.causal, w.q0 + 64 * c};
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};
      float corr[2];
      uint32_t pa[BK / 16][4];

      if (lane == 0) {
        mbar_arrive(&empty_k[n % S]);
        if (w.nk == 1) mbar_arrive(&empty_q[j % QB]);  // the tile's last read of Q
      }
      softmax_step<BK>(s, m, l, corr, rows, 0);
      to_fragment<E, BK>(s, pa);

      // k tile kb: S = Q.K_kb^T and O += P_{kb-1}.V_{kb-1} in flight
      // together, the softmax of S while P.V runs; P_kb replaces P_{kb-1}
      // once P.V is done
      for (int kb = 1; kb < w.nk; ++kb) {
        const int st = (n + kb) % S;
        const int prev = (n + kb - 1) % S;
        mbar_wait(&full_k[st], ((n + kb) / S) & 1);
        mbar_wait(&full_v[prev], ((n + kb - 1) / S) & 1);
        named_sync(turn, 256);
        issue_qk<E, D, BQ, BK>(s, sq_c, sk + st * L::kKVElems);
        if (kb > 1) rescale(o, corr);
        issue_pv<E, D, BK>(o, pa, sv + prev * L::kKVElems, kb > 1);
        named_arrive(other_turn, 256);
        wgmma_wait<1>();
        fence_regs(s);
        if (lane == 0) {
          mbar_arrive(&empty_k[st]);
          if (kb == w.nk - 1) mbar_arrive(&empty_q[j % QB]);
        }
        softmax_step<BK>(s, m, l, corr, rows, kb * BK);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(&empty_v[prev]);
        to_fragment<E, BK>(s, pa);
      }

      // last turn: the tile's last P.V, and the next tile's first S, which
      // runs under this tile's epilogue. Each branch issues and completes
      // its own wgmmas: a wgmma left in flight where the branches meet makes
      // ptxas serialise every wgmma of the kernel.
      const int last = (n + w.nk - 1) % S;
      const uint32_t last_parity = ((n + w.nk - 1) / S) & 1;
      n += w.nk;
      E* oh = static_cast<E*>(a.o) + (size_t)w.bh * t * a.d;
      mbar_wait(&full_v[last], last_parity);
      if (snake_item(j + 1) < tiles) {
        mbar_wait(&full_q[(j + 1) % QB], ((j + 1) / QB) & 1);
        mbar_wait(&full_k[n % S], (n / S) & 1);
        named_sync(turn, 256);
        if (w.nk > 1) rescale(o, corr);
        issue_pv<E, D, BK>(o, pa, sv + last * L::kKVElems, w.nk > 1);
        issue_qk<E, D, BQ, BK>(s, q_rows((j + 1) % QB), sk + (n % S) * L::kKVElems);
        named_arrive(other_turn, 256);
        wgmma_wait<1>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(&empty_v[last]);
        store_tile<E, D>(o, m, l, oh, a.lse_out + (size_t)w.bh * t, row0, lane, t, a.d, a.scale);
        wgmma_wait<0>();
        fence_regs(s);
      } else {
        named_sync(turn, 256);
        if (w.nk > 1) rescale(o, corr);
        issue_pv<E, D, BK>(o, pa, sv + last * L::kKVElems, w.nk > 1);
        named_arrive(other_turn, 256);
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(&empty_v[last]);
        store_tile<E, D>(o, m, l, oh, a.lse_out + (size_t)w.bh * t, row0, lane, t, a.d, a.scale);
      }
    }
  }
}

template <typename E, int D>
cudaError_t fwd_launch(const FlashArgs& a, int bhq, cudaStream_t stream) {
  using L = FwdTiles<D>;
  CUtensorMap tq, tk, tv;
  const int bhkv = bhq / a.hq * a.hkv;
  cudaError_t err;
  if ((err = rows_map<E>(&tq, a.q, bhq, a.t, a.d, L::kBQ)) != cudaSuccess) return err;
  if ((err = rows_map<E>(&tk, a.k, bhkv, a.t, a.d, L::kBK)) != cudaSuccess) return err;
  if ((err = rows_map<E>(&tv, a.v, bhkv, a.t, a.d, L::kBK)) != cudaSuccess) return err;
  auto kernel = flash_fwd_kernel_sm90<E, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  // one persistent block per SM, or one per work tile if there are fewer
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int tiles = bhq * ((a.t + L::kBQ - 1) / L::kBQ);
  kernel<<<tiles < sms ? tiles : sms, 384, L::kSmem, stream>>>(tq, tk, tv, a, bhq);
  return cudaGetLastError();
}

// the instance at a.d's padded width, if (bq, bk) is its one compiled pair;
// ops/flash_attention.py's TILES lists them. 128-row k tiles measured faster
// than 64-row ones at the slice shape (D = 128).
template <typename E, int D>
cudaError_t fwd_tiles(const FlashArgs& a, int bhq, int bq, int bk, cudaStream_t s) {
  if (bq == FwdTiles<D>::kBQ && bk == FwdTiles<D>::kBK) return fwd_launch<E, D>(a, bhq, s);
  return cudaErrorInvalidValue;
}

template <typename E>
cudaError_t fwd_dispatch(const FlashArgs& a, int bhq, int bq, int bk, cudaStream_t s) {
  switch (padded_width(a.d)) {
    case 64: return fwd_tiles<E, 64>(a, bhq, bq, bk, s);
    case 128: return fwd_tiles<E, 128>(a, bhq, bq, bk, s);
    case 256: return fwd_tiles<E, 256>(a, bhq, bq, bk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace fedml_flash

// q, k, v: [bhq or bhkv, t, d] in f32, bf16 or f16 (dtype: DtypeCode); o like
// q; lse [bhq, t] f32. Returns a cudaError_t (0 on success).
extern "C" int fedml_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                               int bhq, int hq, int hkv, int t, int d, int causal, int block_q,
                               int block_k, int dtype, void* stream) {
  fedml_flash::FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse_out = lse;
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
      return counted(kSm90WgmmaTma, sm90::fwd_dispatch<__nv_bfloat16>(a, bhq, block_q, block_k, s));
    case kF16:
      return counted(kSm90WgmmaTma, sm90::fwd_dispatch<__half>(a, bhq, block_q, block_k, s));
    case kF32:
      return counted(kSimtF32Fma, dispatch_simt<FwdLaunch, float>(a, bhq, block_q, block_k, s));
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" long long fedml_flash_fwd_launches(int design) {
  return fedml_flash::design_launches(design);
}
