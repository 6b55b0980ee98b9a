// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ, bf16 in and
// out, f32 lse and delta in.
//
// Replaces the two TPU kernels of ray_tpu/ops/flash_attention.py::
// flash_attention_backward: _dkv_kernel (the first pallas_call) and
// _dq_kernel (the second). Same function: p = exp(s - lse) is recomputed per
// tile from the forward's saved logsumexp, ds = p * (dp - delta) * scale with
// dp = dO V^T and delta = rowsum(dO * O) (computed by the caller, as the JAX
// package computes it outside its kernels), and
//   dV = sum_q p^T dO,  dK = sum_q ds^T Q   (dK/dV kernel)
//   dQ = sum_k ds K                         (dQ kernel)
// No [T, T] tensor is ever written to device memory, and neither kernel uses
// atomics: each output tile is owned by one CTA.
//
// What bounds it on the H100: the dK/dV kernel does 8*D FLOPs per live
// (q, k) pair and the dQ kernel 6*D, against O(T*D*H) bytes, so at training
// shapes both are bound by the tensor cores: at [4,32,2048,64] causal the
// dK/dV kernel's 137 GFLOP take 0.139 ms at 989 TFLOP/s, its bytes 0.015 ms.
// Only wgmma reaches the bf16 tensor-core rate.
//
// dK/dV kernel (wgmma, TMA, mbarrier ring; hopper_tiles.cuh).
// - One CTA of three warpgroups per (kv tile of 128 rows, kv head, batch)
//   keeps its K and V tiles in shared memory and sweeps the G = H / Hkv q
//   heads of its group, for each the q tiles from the diagonal on. The GQA
//   sum over the group therefore happens in the f32 register accumulators,
//   dK/dV come out per kv head, and no atomics are needed.
// - Warpgroup 0 is the producer: one thread loads K and V once, then keeps
//   a ring of two stages of (Q, dO, lse, delta) q tiles in flight by TMA,
//   each stage with a full and an empty mbarrier (40 registers a thread
//   after setmaxnreg).
// - Warpgroups 1 and 2 own 64 kv rows each (232 registers a thread). Per q
//   tile: S^T = K Q^T and dP^T = V dO^T by wgmma with both operands in
//   shared memory; P^T and dS^T formed in registers from lse and delta
//   (read from shared memory) and rounded to bf16; dV += P^T dO and
//   dK += dS^T Q by wgmma with A from registers and dO, Q as MN-major B
//   operands. The q tile is 128 rows at D=64 and 64 at D=128, where the two
//   f32 [64 x 128] accumulators take 128 registers a thread.
// - Elementwise work overlaps the products inside a warpgroup: P^T's exps
//   run while dP^T is computed (separate commit groups), and the second
//   half of the q tile's dS^T while the first half's dV, dK products run.
//   The scale of dS is applied to dK once, at the store.
// - Edge tiles: TMA zero-fills rows >= T; P^T is masked for keys after
//   their query and for query rows >= T, and no row >= T is stored.
// - The previous version (mma.sync per warp, ldmatrix, cp.async issued by
//   the compute threads, 228 registers at D=64) reached 18 % of its bound.
//
// dQ kernel (unchanged; mma_tiles.cuh).
// - One CTA of 4 warps per (q tile of 64 rows, q head, batch) keeps Q's and
//   dO's fragments in registers and sweeps the kv tiles up to the diagonal:
//   S = Q K^T, dP = dO V^T, and dQ += dS K with dS rounded to bf16 in
//   registers; mma.sync m16n8k16 bf16 with f32 accumulation, ldmatrix
//   (plain and transposed) from padded shared-memory rows, cp.async double
//   buffering of the kv tiles, consumed in column chunks of CH (64 at D=64,
//   32 at D=128) so the score tiles and the [16 x D] accumulator fit in
//   registers at D=128.
// - Any strides with a unit last dim for q, k, v, dO and the outputs in
//   both kernels, so the [B,T,H,D] activations of the model go in as
//   transposed views.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace hopper_tiles;
using namespace mma_tiles;
using bf16 = __nv_bfloat16;

// dQ kernel tiles
constexpr int BT = 64;          // rows of a q tile and of a kv tile
constexpr int NWARPS = 4;       // 16 rows of the CTA's fixed tile per warp
constexpr int NTHREADS = NWARPS * 32;

template <int D>
struct Cfg {
  static constexpr int LD = D + 8;       // bf16 row stride: ldmatrix conflict-free
  static constexpr int TILE = BT * LD;   // bf16 elements of one smem tile
  static constexpr int CH = D == 128 ? 32 : 64;  // swept columns per chunk
  static constexpr int KD = D / 16;      // k16 steps over the head dim
  static constexpr int ND = D / 8;       // n8 tiles of a [16 x D] accumulator
  static constexpr int NC = CH / 8;      // n8 tiles of a score chunk
  // six tiles: two fixed, two double-buffered pairs
  static constexpr size_t tiles_bytes = sizeof(bf16) * TILE * 6;
};

template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long st) {
  mma_tiles::load_tile_async<BT, D, Cfg<D>::LD, NTHREADS>(dst, src, st);
}

// Write a warp's [16 x D] f32 accumulator (rows r0 + g, r0 + g + 8) as bf16.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long st,
                                           const float (&acc)[D / 8][4],
                                           int r0, int g, int c2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* row = out + (long long)(r0 + g + i * 8) * st;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(row + nt * 8 + c2) =
          __floats2bfloat162_rn(acc[nt][2 * i], acc[nt][2 * i + 1]);
  }
}

// dK/dV kernel: wgmma on TMA-fed tiles (hopper_tiles.cuh)
constexpr int BKV = 128;         // kv rows per CTA, 64 per consumer warpgroup
constexpr int DKV_THREADS = 384; // producer warpgroup + two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Dkv {
  // q rows per swept tile: at D = 128 two f32 [64 x 128] accumulators leave
  // room for [64 x 64] score tiles only
  static constexpr int BQ = D == 64 ? 128 : 64;
  static constexpr int STAGES = 3;
  static constexpr int KV_BYTES = BKV * D * 2;     // the K or the V tile
  static constexpr int QT_BYTES = BQ * D * 2;      // one Q or dO tile
  static constexpr int STAT_BYTES = BQ * 4;        // lse or delta of a q tile
  // Q, dO, lse, delta; padded so every stage stays 1024-byte aligned
  static constexpr int STAGE_BYTES = 2 * QT_BYTES + 1024;
  static constexpr int STAGE_TX = 2 * QT_BYTES + 2 * STAT_BYTES;
  static constexpr int BAR_OFF = 2 * KV_BYTES + STAGES * STAGE_BYTES;
  static constexpr size_t smem = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

// d (+)= A B^T over one k16 step, both from shared memory, N = 64 or 128
template <int N>
__device__ __forceinline__ void ss_tile(float (&d)[N / 2], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, da, db, scale_d);
  else
    wgmma_ss_n64(d, da, db, scale_d);
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tlse,
                     const __grid_constant__ CUtensorMap tdelta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int H, int Hkv, int T,
                     long long dk_sb, long long dk_sh, long long dk_st,
                     long long dv_sb, long long dv_sh, long long dv_st,
                     float scale, int causal) {
  using C = Dkv<D>;
  constexpr int BQ = C::BQ;
  extern __shared__ __align__(128) unsigned char smem_raw[];  // as dQ's
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t ks = base;
  const uint32_t vs = base + C::KV_BYTES;
  auto qs = [&](int s) { return base + 2 * C::KV_BYTES + s * C::STAGE_BYTES; };
  auto dos = [&](int s) { return qs(s) + C::QT_BYTES; };
  auto lses = [&](int s) { return qs(s) + 2 * C::QT_BYTES; };
  auto dels = [&](int s) { return lses(s) + 512; };
  const uint32_t bars = base + C::BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };
  const uint32_t kv_full = bars + 8 * 2 * C::STAGES;
  static_assert(C::smem <= 232448, "shared memory of one CTA");

  // x fastest: every (kv head, batch) of kv tile 0, whose causal sweep is
  // the longest, starts first
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int jk = blockIdx.z;
  const int G = H / Hkv;
  const int kv0 = jk * BKV;
  const int i0 = causal ? kv0 / BQ : 0;   // first live q tile
  const int n_i = (T + BQ - 1) / BQ - i0;
  const int n_it = G * n_i;               // (q head, q tile) pairs to sweep

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(kv_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    regs_shrink<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
      tma_tile<D, BKV>(ks, &tk, kv_full, kv0, kvh, b);
      tma_tile<D, BKV>(vs, &tv, kv_full, kv0, kvh, b);
      // sweep step it: q head kvh * G + it / n_i, q tile i0 + it % n_i
      for (int it = 0; it < n_it; ++it) {
        const int s = it % C::STAGES;
        const int h = kvh * G + it / n_i;
        const int q0 = (i0 + it % n_i) * BQ;
        mbar_wait(empty(s), ((it / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), C::STAGE_TX);
        tma_tile<D, BQ>(qs(s), &tq, full(s), q0, h, b);
        tma_tile<D, BQ>(dos(s), &tdo, full(s), q0, h, b);
        tma_load_3d(lses(s), &tlse, full(s), q0, h, b);
        tma_load_3d(dels(s), &tdelta, full(s), q0, h, b);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_grow<232>();
    const int cw = wg - 1;             // this warpgroup's 64 kv rows
    const int w = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int c2 = (lane % 4) * 2;
    const float sl2 = scale * LOG2E;
    const uint32_t ka = ks + cw * 64 * 128;
    const uint32_t va = vs + cw * 64 * 128;
    const int kv_row = kv0 + cw * 64 + w * 16 + g;  // rows kv_row, kv_row + 8

    float dka[D / 64][32], dva[D / 64][32];  // 64-column blocks
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[nb][i] = dva[nb][i] = 0.f;
    float st[BQ / 2], dpt[BQ / 2];           // S^T, dP^T of a q tile
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];  // P^T, dS^T as A operands
    // k16 step kk of a K-major operand: box kk / 4, 32 bytes per step
    auto a_off = [](int kk) { return (kk / 4) * BKV * 128 + (kk % 4) * 32; };
    auto b_off = [](int kk) { return (kk / 4) * BQ * 128 + (kk % 4) * 32; };
    // the registers a dV, dK product reads or writes while it runs
    auto fence_acc = [](float (&v)[D / 64][32], float (&k)[D / 64][32],
                        uint32_t (&p)[BQ / 16][4], uint32_t (&d)[BQ / 16][4]) {
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb) {
        fence_regs(v[nb]);
        fence_regs(k[nb]);
      }
      fence_regs(p);
      fence_regs(d);
    };

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % C::STAGES;
      const int q0 = (i0 + it % n_i) * BQ;
      mbar_wait(full(s), (it / C::STAGES) & 1);

      // S^T = K Q^T, then dP^T = V dO^T ([64 kv rows x BQ q columns]), each
      // its own commit group: P^T's exps run while dP^T is computed
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ss_tile<BQ>(st, desc_sw128(ka + a_off(kk)),
                    desc_sw128(qs(s) + b_off(kk)), kk > 0);
      wgmma_commit();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ss_tile<BQ>(dpt, desc_sw128(va + a_off(kk)),
                    desc_sw128(dos(s) + b_off(kk)), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // P^T = exp(S^T * scale - lse); masked: keys after their query, and
      // query rows >= T
      const float* lt = reinterpret_cast<const float*>(smem_raw + (lses(s) - raw));
      const float* et = reinterpret_cast<const float*>(smem_raw + (dels(s) - raw));
      const bool edge = (causal && q0 < kv0 + BKV) || q0 + BQ > T;
#pragma unroll
      for (int jt = 0; jt < BQ / 8; ++jt) {  // n8 tile: q rows jt*8 + c2 + 0/1
        const float2 l2 = *reinterpret_cast<const float2*>(lt + jt * 8 + c2);
        const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jt + e;
          float p = exp2_approx(fmaf(st[i], sl2, nl[e & 1]));
          if (edge) {
            const int qr = q0 + jt * 8 + c2 + (e & 1);
            const int kr = kv_row + (e >> 1) * 8;
            if ((causal && qr < kr) || qr >= T) p = 0.f;
          }
          st[i] = p;
        }
      }
      wgmma_wait<0>();
      fence_regs(dpt);

      // dS^T / scale = P^T (dP^T - delta) (the scale is applied to dK at the
      // end), then dV += P^T dO and dK += dS^T Q with dO and Q as MN-major B
      // operands, in two halves of the q tile: the second half's elementwise
      // work runs while the first half's products are on the tensor cores
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int kk = half * BQ / 32; kk < (half + 1) * BQ / 32; ++kk) {
#pragma unroll
          for (int jt = 2 * kk; jt < 2 * kk + 2; ++jt) {
            const float2 d2 =
                *reinterpret_cast<const float2*>(et + jt * 8 + c2);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[4 * jt + e] =
                  st[4 * jt + e] * (dpt[4 * jt + e] - (e & 1 ? d2.y : d2.x));
          }
          pa[kk][0] = to_bf16x2(st[8 * kk + 0], st[8 * kk + 1]);
          pa[kk][1] = to_bf16x2(st[8 * kk + 2], st[8 * kk + 3]);
          pa[kk][2] = to_bf16x2(st[8 * kk + 4], st[8 * kk + 5]);
          pa[kk][3] = to_bf16x2(st[8 * kk + 6], st[8 * kk + 7]);
          dsa[kk][0] = to_bf16x2(dpt[8 * kk + 0], dpt[8 * kk + 1]);
          dsa[kk][1] = to_bf16x2(dpt[8 * kk + 2], dpt[8 * kk + 3]);
          dsa[kk][2] = to_bf16x2(dpt[8 * kk + 4], dpt[8 * kk + 5]);
          dsa[kk][3] = to_bf16x2(dpt[8 * kk + 6], dpt[8 * kk + 7]);
        }
        fence_acc(dva, dka, pa, dsa);
        wgmma_fence();
#pragma unroll
        for (int kk = half * BQ / 32; kk < (half + 1) * BQ / 32; ++kk)
#pragma unroll
          for (int nb = 0; nb < D / 64; ++nb) {
            const uint32_t off = nb * BQ * 128 + kk * 2048;
            wgmma_rs_n64(dva[nb], pa[kk], desc_sw128(dos(s) + off), 1);
            wgmma_rs_n64(dka[nb], dsa[kk], desc_sw128(qs(s) + off), 1);
          }
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_acc(dva, dka, pa, dsa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }

    // dK, dV rows < T as bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kv_row + r * 8;
      if (row >= T) continue;
      bf16* krow = dk + b * dk_sb + kvh * dk_sh + (long long)row * dk_st;
      bf16* vrow = dv + b * dv_sb + kvh * dv_sh + (long long)row * dv_st;
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
        for (int jt = 0; jt < 8; ++jt) {
          const int col = nb * 64 + jt * 8 + c2;
          *reinterpret_cast<__nv_bfloat162*>(krow + col) =
              __floats2bfloat162_rn(dka[nb][4 * jt + 2 * r] * scale,
                                    dka[nb][4 * jt + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(vrow + col) =
              __floats2bfloat162_rn(dva[nb][4 * jt + 2 * r],
                                    dva[nb][4 * jt + 2 * r + 1]);
        }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int Hkv, int T,
                    long long q_sb, long long q_sh, long long q_st,
                    long long k_sb, long long k_sh, long long k_st,
                    long long v_sb, long long v_sh, long long v_st,
                    long long d_sb, long long d_sh, long long d_st,
                    long long dq_sb, long long dq_sh, long long dq_st,
                    float scale, int causal) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, CH = C::CH, KD = C::KD, ND = C::ND, NC = C::NC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // Q, dO, then (K, V) buffer 0, (K, V) buffer 1
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + C::TILE;
  auto Ks = [&](int buf) { return Qs + (2 + 2 * buf) * C::TILE; };
  auto Vs = [&](int buf) { return Qs + (3 + 2 * buf) * C::TILE; };

  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;       // this warp's q rows within the tile
  const int g = lane / 4;
  const int c2 = (lane % 4) * 2;
  const int lm = lane / 8;
  const int lr = lane % 8;

  const long long q0 = (long long)qi * BT;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;
  const int n_kv = causal ? qi + 1 : T / BT;  // BQ == BK: diagonal tile = qi

  stage_tile<D>(Qs, q + b * q_sb + h * q_sh + q0 * q_st, q_st);
  stage_tile<D>(Ds, dout + b * d_sb + h * d_sh + q0 * d_st, d_st);
  stage_tile<D>(Ks(0), kb, k_st);
  stage_tile<D>(Vs(0), vb, v_st);
  cp_async_commit();

  // lse and delta of rows g and g + 8 of this warp
  const long long r = ((long long)b * H + h) * T + q0 + r0 + g;
  const float lse_r[2] = {lse[r], lse[r + 8]};
  const float del_r[2] = {delta[r], delta[r + 8]};

  uint32_t qf[KD][4], df[KD][4];  // Q and dO A-fragments, loaded once
  float dqa[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nt][e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {  // prefetch the next kv tile into the other buffer
      stage_tile<D>(Ks(buf ^ 1), kb + (long long)(j + 1) * BT * k_st, k_st);
      stage_tile<D>(Vs(buf ^ 1), vb + (long long)(j + 1) * BT * v_st, v_st);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int off = (r0 + lr + (lm % 2) * 8) * LD + kk * 16 + (lm / 2) * 8;
        ldmatrix_x4(qf[kk], Qs + off);
        ldmatrix_x4(df[kk], Ds + off);
      }
    }
    const bf16* Kt = Ks(buf);
    const bf16* Vt = Vs(buf);
    const bool diag = causal && j == qi;

    for (int c0 = 0; c0 < BT; c0 += CH) {
      // S = Q K^T and dP = dO V^T: [16 q rows x CH kv columns]
      float s[NC][4], dp[NC][4];
#pragma unroll
      for (int nt = 0; nt < NC; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          uint32_t kf[4], vf[4];  // b0,b1 of key tiles 2np and 2np+1
          const int row = c0 + (2 * np + lm / 2) * 8 + lr;
          ldmatrix_x4(kf, Kt + row * LD + kk * 16 + (lm % 2) * 8);
          ldmatrix_x4(vf, Vt + row * LD + kk * 16 + (lm % 2) * 8);
          mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
          mma_bf16(dp[2 * np], df[kk], vf[0], vf[1]);
          mma_bf16(dp[2 * np + 1], df[kk], vf[2], vf[3]);
        }
      }

      // dS, rounded to bf16 as the A operand of dQ += dS K
      uint32_t dsa[CH / 16][4];
#pragma unroll
      for (int nt = 0; nt < NC; ++nt) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + nt * 8 + c2 + (e & 1);  // kv row in its tile
          const int row = r0 + g + (e >> 1) * 8;       // q row in its tile
          float pe = __expf(s[nt][e] * scale - lse_r[e >> 1]);
          if (diag && col > row) pe = 0.f;  // key after the query: masked
          ds[e] = pe * (dp[nt][e] - del_r[e >> 1]) * scale;
        }
        dsa[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t kf[4];  // b0,b1 of d tiles 2np and 2np+1
          ldmatrix_x4_trans(kf, Kt + (c0 + kk * 16 + (lm % 2) * 8 + lr) * LD +
                                    (2 * np + lm / 2) * 8);
          mma_bf16(dqa[2 * np], dsa[kk], kf[0], kf[1]);
          mma_bf16(dqa[2 * np + 1], dsa[kk], kf[2], kf[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

  store_rows<D>(dq + b * dq_sb + h * dq_sh + q0 * dq_st, dq_st, dqa, r0, g,
                c2);
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Hkv, int T,
                       const long long* st, float scale, int causal,
                       cudaStream_t stream) {
  constexpr int BQ = Dkv<D>::BQ;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  if (!encode_rows(&tq, q, B, H, T, D, st[0], st[1], st[2], BQ) ||
      !encode_rows(&tk, k, B, Hkv, T, D, st[3], st[4], st[5], BKV) ||
      !encode_rows(&tv, v, B, Hkv, T, D, st[6], st[7], st[8], BKV) ||
      !encode_rows(&tdo, dout, B, H, T, D, st[9], st[10], st[11], BQ) ||
      !encode_stats(&tlse, lse, B, H, T, BQ) ||
      !encode_stats(&tdelta, delta, B, H, T, BQ))
    return cudaErrorInvalidValue;
  const size_t smem = Dkv<D>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B, (T + BKV - 1) / BKV);
  flash_bwd_dkv_kernel<D><<<grid, DKV_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Hkv, T, st[12], st[13], st[14], st[15],
      st[16], st[17], scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Hkv, int T,
                      const long long* st, float scale, int causal,
                      cudaStream_t stream) {
  const size_t smem = Cfg<D>::tiles_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(T / BT, H, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, Hkv, T,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 18 int64 element strides (batch, head, time) for q, k, v, dO,
// dK, dV; lse and delta are contiguous [B, H, T] f32 buffers; dK and dV are
// [B, Hkv, T, D]. T must be a multiple of 64 and D 64 or 128. Device
// pointers and layouts are checked before any tensor map is encoded.
// Returns the CUDA error code of the launch (0 = success).
int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int H, int Hkv, int T, int D,
                                 const long long* strides, float scale,
                                 int causal, void* stream) {
  const long long* st = strides;
  const void* rows[6] = {q, k, v, dout, dk, dv};
  if ((D != 64 && D != 128) || T <= 0 || T % 64 || B <= 0 || Hkv <= 0 ||
      H % Hkv)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 6; ++i)
    if (!on_device(rows[i]) ||
        !rows_layout_ok(rows[i], st[3 * i], st[3 * i + 1], st[3 * i + 2]))
      return (int)cudaErrorInvalidValue;
  if (!on_device(lse) || !on_device(delta)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                                T, st, scale, causal, s);
  return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, T,
                             st, scale, causal, s);
}

// strides: 15 int64 element strides (batch, head, time) for q, k, v, dO, dQ;
// otherwise as above.
int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int Hkv, int T, int D,
                                const long long* strides, float scale,
                                int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, T,
                               strides, scale, causal, s);
  if (D == 64)
    return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, T,
                              strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
