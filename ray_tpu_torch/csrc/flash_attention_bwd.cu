// Flash-attention backward for Hopper (sm_90a): dQ (with delta) and dK/dV,
// bf16 in and out, f32 lse in, f32 delta out of the dQ kernel and into the
// dK/dV kernel.
//
// Replaces the two TPU kernels of ray_tpu/ops/flash_attention.py::
// flash_attention_backward: _dkv_kernel (the first pallas_call) and
// _dq_kernel (the second). Same function: p = exp(s - lse) is recomputed per
// tile from the forward's saved logsumexp, ds = p * (dp - delta) * scale with
// dp = dO V^T and delta = rowsum(dO * O), and
//   dQ = sum_k ds K                         (dQ kernel)
//   dV = sum_q p^T dO,  dK = sum_q ds^T Q   (dK/dV kernel)
// The JAX package computes delta outside its kernels; here the dQ kernel
// computes it from the dO and O tiles it holds anyway and writes it out, and
// the caller launches the dK/dV kernel after it on the same stream. No [T, T]
// tensor is ever written to device memory, and neither kernel uses atomics:
// each output tile is owned by one CTA.
//
// What bounds it on the H100: the dK/dV kernel does 8*D FLOPs per live
// (q, k) pair and the dQ kernel 6*D, against O(T*D*H) bytes, so at training
// shapes both are bound by the tensor cores: at [4,32,2048,64] causal the
// dK/dV kernel's 137 GFLOP take 0.139 ms at 989 TFLOP/s, its bytes 0.015 ms;
// the dQ kernel's 103 GFLOP take 0.104 ms. Only wgmma reaches the bf16
// tensor-core rate.
//
// Both kernels are built the same way from hopper_tiles.cuh: one CTA of
// three warpgroups, warpgroup 0 a producer (one thread issuing TMA loads,
// 40 registers a thread after setmaxnreg), warpgroups 1 and 2 consumers of
// 64 output rows each (232 registers a thread), a ring of stages in 128-byte
// swizzled shared memory with a full and an empty mbarrier per stage.
//
// dQ kernel.
// - One CTA per (q tile of 128 rows, q head, batch), reading kv head
//   h / (H / Hkv). The producer loads the Q, dO and O tiles once, then keeps
//   a ring of three stages of (K, V) tiles in flight. The kv tile is 128
//   rows at D=64 and 64 at D=128, where the f32 [64 x 128] dQ accumulator
//   leaves room for [64 x 64] score tiles only.
// - Before the sweep each consumer computes delta = rowsum(dO * O) in f32
//   for its 64 rows from the swizzled dO and O tiles (the four lanes of a
//   quad take interleaved 16-byte chunks of a row, then sum across the
//   quad), keeps it in registers in the accumulator's row layout, and
//   stores it for rows < T into the [B, H, T] buffer the dK/dV kernel reads.
// - Per kv tile: S = Q K^T and dP = dO V^T by wgmma with both operands in
//   shared memory, in two commit groups, so P's exps run while dP is
//   computed; dS = P (dP - delta) formed in registers and rounded to bf16
//   once; dQ += dS K by wgmma with dS as the register A operand and K as
//   the MN-major B operand read from the same swizzled tile, in two halves
//   of the kv tile, so the second half's dS is formed while the first
//   half's product runs. The scale of dS is applied to dQ once, at the
//   store.
// - CTAs start heaviest causal q tile first across all heads and batches
//   (x = head, z = tile order).
//
// dK/dV kernel.
// - One CTA per (kv tile of 128 rows, kv head, batch) keeps its K and V
//   tiles in shared memory and sweeps the G = H / Hkv q heads of its group,
//   for each the q tiles from the diagonal on. The GQA sum over the group
//   therefore happens in the f32 register accumulators, dK/dV come out per
//   kv head, and no atomics are needed.
// - The producer loads K and V once, then keeps a ring of three stages of
//   (Q, dO, lse, delta) q tiles in flight.
// - Per q tile: S^T = K Q^T and dP^T = V dO^T by wgmma with both operands in
//   shared memory; P^T and dS^T formed in registers from lse and delta
//   (read from shared memory) and rounded to bf16; dV += P^T dO and
//   dK += dS^T Q by wgmma with A from registers and dO, Q as MN-major B
//   operands. The q tile is 128 rows at D=64 and 64 at D=128, where the two
//   f32 [64 x 128] accumulators take 128 registers a thread.
// - Elementwise work overlaps the products inside a warpgroup: P^T's exps
//   run while dP^T is computed (separate commit groups), and the second
//   half of the q tile's dS^T while the first half's dV, dK products run.
//   The scale of dS is applied to dK once, at the store.
//
// Both kernels: TMA zero-fills rows >= T; keys after their query and rows
// >= T are masked, and no row >= T is stored. Any strides with a unit last
// dim for q, k, v, dO, O and the outputs, so the [B,T,H,D] activations of
// the model go in as transposed views. The previous versions (mma.sync per
// warp, ldmatrix, cp.async issued by the compute threads) reached 18 %
// (dK/dV) and 23 % (dQ, with delta a separate PyTorch reduction) of their
// bounds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

using namespace hopper_tiles;
using bf16 = __nv_bfloat16;

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

// dQ kernel: wgmma on TMA-fed tiles, delta computed in the kernel
constexpr int BQ_DQ = 128;       // q rows per CTA, 64 per consumer warpgroup
constexpr int DQ_THREADS = 384;  // producer warpgroup + two consumer warpgroups

template <int D>
struct Dq {
  // kv rows per swept tile: at D = 128 the f32 [64 x 128] dQ accumulator
  // leaves room for [64 x 64] S and dP tiles only
  static constexpr int BK = D == 64 ? 128 : 64;
  static constexpr int STAGES = 3;
  static constexpr int QT_BYTES = BQ_DQ * D * 2;   // the Q, dO or O tile
  static constexpr int KV_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = 3 * QT_BYTES + STAGES * STAGE_BYTES;
  static constexpr size_t smem = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

// sum of the eight products of two 16-byte chunks of bf16, in f32
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w};
  const uint32_t y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[i]));
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y[i]));
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap to,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Hkv, int T,
                    long long dq_sb, long long dq_sh, long long dq_st,
                    float scale, int causal) {
  using C = Dq<D>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem_raw[];  // as dK/dV's
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t qs = base;
  const uint32_t dos = base + C::QT_BYTES;
  const uint32_t os = base + 2 * C::QT_BYTES;
  auto ks = [&](int s) { return base + 3 * C::QT_BYTES + s * C::STAGE_BYTES; };
  auto vs = [&](int s) { return ks(s) + C::KV_BYTES; };
  const uint32_t bars = base + C::BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };
  const uint32_t q_full = bars + 8 * 2 * C::STAGES;
  static_assert(C::smem <= 232448, "shared memory of one CTA");

  // x fastest: every (head, batch) of the heaviest causal q tile first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qi = gridDim.z - 1 - blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q0 = qi * BQ_DQ;
  const int kv_end = causal ? min(q0 + BQ_DQ, T) : T;  // keys < kv_end
  const int n_kv = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    regs_shrink<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 3 * C::QT_BYTES);
      tma_tile<D, BQ_DQ>(qs, &tq, q_full, q0, h, b);
      tma_tile<D, BQ_DQ>(dos, &tdo, q_full, q0, h, b);
      tma_tile<D, BQ_DQ>(os, &to, q_full, q0, h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % C::STAGES;
        mbar_wait(empty(s), ((j / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), C::STAGE_BYTES);
        tma_tile<D, BK>(ks(s), &tk, full(s), j * BK, kvh, b);
        tma_tile<D, BK>(vs(s), &tv, full(s), j * BK, kvh, b);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_grow<232>();
    const int cw = wg - 1;             // this warpgroup's 64 rows of the tile
    const int w = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int c2 = (lane % 4) * 2;
    const float sl2 = scale * LOG2E;
    const uint32_t qa = qs + cw * 64 * 128;
    const uint32_t da = dos + cw * 64 * 128;
    const int tr0 = cw * 64 + w * 16 + g;  // tile rows tr0, tr0 + 8
    const int row0 = q0 + tr0;
    const long long stat0 = ((long long)b * H + h) * T;

    // -lse in log2 units; a row >= T gets 0, which keeps its P finite (its
    // dO, hence its dS, is zero, and it is never stored)
    float nl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      nl[r] = row0 + 8 * r < T ? -lse[stat0 + row0 + 8 * r] * LOG2E : 0.f;

    // delta = rowsum(dO * O) in f32 from the swizzled tiles: 16-byte chunk
    // c of tile row r sits at chunk c ^ (r % 8) of its 128-byte row
    mbar_wait(q_full, 0);
    float del[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tr = tr0 + 8 * r;
      float acc = 0.f;
#pragma unroll
      for (int ch = lane % 4; ch < D / 8; ch += 4) {
        const uint32_t off =
            (ch / 8) * BQ_DQ * 128 + tr * 128 + ((ch % 8) ^ (tr % 8)) * 16;
        const uint4 x = *reinterpret_cast<const uint4*>(smem_raw + (dos + off - raw));
        const uint4 y = *reinterpret_cast<const uint4*>(smem_raw + (os + off - raw));
        acc = dot8(x, y, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      del[r] = acc;
      if (lane % 4 == 0 && row0 + 8 * r < T) delta[stat0 + row0 + 8 * r] = acc;
    }

    float dqa[D / 64][32];  // dQ: 64-column blocks, wgmma accumulator layout
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[nb][i] = 0.f;
    float sacc[BK / 2], dpacc[BK / 2];  // S, dP of a kv tile
    uint32_t dsa[BK / 16][4];           // dS as the A operand of dQ += dS K
    // k16 step kk of a K-major operand: box kk / 4, 32 bytes per step
    auto a_off = [](int kk) { return (kk / 4) * BQ_DQ * 128 + (kk % 4) * 32; };
    auto b_off = [](int kk) { return (kk / 4) * BK * 128 + (kk % 4) * 32; };

    for (int j = 0; j < n_kv; ++j) {
      const int s = j % C::STAGES;
      mbar_wait(full(s), (j / C::STAGES) & 1);

      // S = Q K^T, then dP = dO V^T ([64 q rows x BK keys]), each its own
      // commit group: P's exps run while dP is computed
      fence_regs(sacc);
      fence_regs(dpacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ss_tile<BK>(sacc, desc_sw128(qa + a_off(kk)),
                    desc_sw128(ks(s) + b_off(kk)), kk > 0);
      wgmma_commit();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ss_tile<BK>(dpacc, desc_sw128(da + a_off(kk)),
                    desc_sw128(vs(s) + b_off(kk)), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sacc);

      // P = exp(S * scale - lse); masked: keys after their query (on the
      // tiles that reach past this warpgroup's first row) and keys >= T
      const bool edge = (causal && (j + 1) * BK > q0 + cw * 64) ||
                        (j + 1) * BK > T;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2_approx(fmaf(sacc[i], sl2, nl[r]));
        if (edge) {
          const int key = j * BK + (i / 4) * 8 + c2 + (i & 1);
          if ((causal && key > row0 + 8 * r) || key >= T) p = 0.f;
        }
        sacc[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dpacc);

      // dS / scale = P (dP - delta), rounded to bf16 once, and dQ += dS K
      // (K the MN-major B operand) in two halves of the kv tile: the second
      // half's dS is formed while the first half's product runs
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int kk = half * BK / 32; kk < (half + 1) * BK / 32; ++kk) {
#pragma unroll
          for (int i = 8 * kk; i < 8 * kk + 8; ++i)
            dpacc[i] = sacc[i] * (dpacc[i] - del[(i >> 1) & 1]);
          dsa[kk][0] = to_bf16x2(dpacc[8 * kk + 0], dpacc[8 * kk + 1]);
          dsa[kk][1] = to_bf16x2(dpacc[8 * kk + 2], dpacc[8 * kk + 3]);
          dsa[kk][2] = to_bf16x2(dpacc[8 * kk + 4], dpacc[8 * kk + 5]);
          dsa[kk][3] = to_bf16x2(dpacc[8 * kk + 6], dpacc[8 * kk + 7]);
        }
#pragma unroll
        for (int nb = 0; nb < D / 64; ++nb) fence_regs(dqa[nb]);
        fence_regs(dsa);
        wgmma_fence();
#pragma unroll
        for (int kk = half * BK / 32; kk < (half + 1) * BK / 32; ++kk)
#pragma unroll
          for (int nb = 0; nb < D / 64; ++nb)
            wgmma_rs_n64(dqa[nb], dsa[kk],
                         desc_sw128(ks(s) + nb * BK * 128 + kk * 2048), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb) fence_regs(dqa[nb]);
      fence_regs(dsa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }

    // dQ rows < T as bf16, the scale of dS applied here
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row >= T) continue;
      bf16* qrow = dq + b * dq_sb + h * dq_sh + (long long)row * dq_st;
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
        for (int jt = 0; jt < 8; ++jt)
          *reinterpret_cast<__nv_bfloat162*>(qrow + nb * 64 + jt * 8 + c2) =
              __floats2bfloat162_rn(dqa[nb][4 * jt + 2 * r] * scale,
                                    dqa[nb][4 * jt + 2 * r + 1] * scale);
    }
  }
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
                      const void* dout, const void* o, const void* lse,
                      void* delta, void* dq, int B, int H, int Hkv, int T,
                      const long long* st, float scale, int causal,
                      cudaStream_t stream) {
  constexpr int BK = Dq<D>::BK;
  CUtensorMap tq, tk, tv, tdo, to;
  if (!encode_rows(&tq, q, B, H, T, D, st[0], st[1], st[2], BQ_DQ) ||
      !encode_rows(&tk, k, B, Hkv, T, D, st[3], st[4], st[5], BK) ||
      !encode_rows(&tv, v, B, Hkv, T, D, st[6], st[7], st[8], BK) ||
      !encode_rows(&tdo, dout, B, H, T, D, st[9], st[10], st[11], BQ_DQ) ||
      !encode_rows(&to, o, B, H, T, D, st[12], st[13], st[14], BQ_DQ))
    return cudaErrorInvalidValue;
  const size_t smem = Dq<D>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (T + BQ_DQ - 1) / BQ_DQ);
  flash_bwd_dq_kernel<D><<<grid, DQ_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, to, static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), H, Hkv, T, st[15],
      st[16], st[17], scale, causal);
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
// strides: 18 int64 element strides (batch, head, time) for q, k, v, dO, O,
// dQ; lse is a contiguous [B, H, T] f32 buffer and delta one the kernel
// writes (rowsum(dO * O), which the dK/dV kernel reads). Otherwise as above:
// the same checks, made before any tensor map is encoded.
int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const void* o,
                                const void* lse, void* delta, void* dq, int B,
                                int H, int Hkv, int T, int D,
                                const long long* strides, float scale,
                                int causal, void* stream) {
  const long long* st = strides;
  const void* rows[6] = {q, k, v, dout, o, dq};
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
    return (int)launch_dq<128>(q, k, v, dout, o, lse, delta, dq, B, H, Hkv, T,
                               st, scale, causal, s);
  return (int)launch_dq<64>(q, k, v, dout, o, lse, delta, dq, B, H, Hkv, T,
                            st, scale, causal, s);
}

}  // extern "C"
