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
// Design.
// - Tiles of 64 q rows and 64 kv rows; CTAs of 4 warps, each warp owning 16
//   rows of the CTA's fixed tile. The TPU kernels' sequential inner grid
//   axis becomes a loop inside the CTA, and causal tiles above the diagonal
//   are never visited.
// - dK/dV: one CTA per (kv tile, kv head, batch) keeps its K/V tile in
//   shared memory and sweeps the G = H / Hkv q heads of its group, for each
//   the q tiles from the diagonal on. The GQA sum over the group therefore
//   happens in the f32 register accumulators, and dK/dV come out per kv
//   head. Each warp computes S^T = K Q^T and dP^T = V dO^T for its 16 kv
//   rows, forms P^T and dS^T in registers, rounds them to bf16 and feeds
//   them straight back as the A operands of dV += P^T dO and dK += dS^T Q.
// - dQ: one CTA per (q tile, q head, batch) keeps Q's and dO's fragments in
//   registers and sweeps the kv tiles up to the diagonal: S = Q K^T,
//   dP = dO V^T, and dQ += dS K with dS rounded to bf16 in registers.
// - Both kernels use the forward's blocks (mma_tiles.cuh): mma.sync
//   m16n8k16 bf16 with f32 accumulation, ldmatrix (plain and transposed)
//   from padded shared-memory rows, and cp.async double buffering of the
//   swept tiles. The swept tile is consumed in column chunks of CH (64 at
//   D=64, 32 at D=128) so that the score tiles of a chunk and the two f32
//   [16 x D] accumulators fit in registers at D=128.
// - Any strides with a unit last dim for q, k, v, dO and the outputs, so
//   the [B,T,H,D] activations of the model go in as transposed views.
//
// What bounds it on the H100: the dK/dV kernel does 8*D FLOPs per live
// (q, k) pair and the dQ kernel 6*D, against O(T*D*H) bytes, so at training
// shapes both are bound by the tensor cores. mma.sync does not reach the
// bf16 peak that wgmma (with TMA-fed tiles) can; that is the next step, and
// PERF.md holds this version's measured times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;
using bf16 = __nv_bfloat16;

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

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int H, int Hkv, int T,
                     long long q_sb, long long q_sh, long long q_st,
                     long long k_sb, long long k_sh, long long k_st,
                     long long v_sb, long long v_sh, long long v_st,
                     long long d_sb, long long d_sh, long long d_st,
                     long long dk_sb, long long dk_sh, long long dk_st,
                     long long dv_sb, long long dv_sh, long long dv_st,
                     float scale, int causal) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, CH = C::CH, KD = C::KD, ND = C::ND, NC = C::NC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // K, V, then (Q, dO) buffer 0, (Q, dO) buffer 1, then per buffer the
  // 64 lse values and 64 delta values of the q tile
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + C::TILE;
  auto Qs = [&](int buf) { return Ks + (2 + 2 * buf) * C::TILE; };
  auto Ds = [&](int buf) { return Ks + (3 + 2 * buf) * C::TILE; };
  float* stats = reinterpret_cast<float*>(smem_raw + C::tiles_bytes);
  auto Ls = [&](int buf) { return stats + buf * 2 * BT; };
  auto Es = [&](int buf) { return stats + buf * 2 * BT + BT; };

  const int j = blockIdx.x;  // kv tile: the causal sweep is longest at j = 0
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;       // this warp's kv rows within the tile
  const int g = lane / 4;
  const int c2 = (lane % 4) * 2;
  const int lm = lane / 8;
  const int lr = lane % 8;

  const long long k0 = (long long)j * BT;
  const int i0 = causal ? j : 0;          // first live q tile (BQ == BK)
  const int n_i = T / BT - i0;
  const int n_it = G * n_i;               // (q head, q tile) pairs to sweep

  // stage sweep step `it` (q head kvh * G + it / n_i, q tile i0 + it % n_i)
  auto issue = [&](int it, int buf) {
    const int h = kvh * G + it / n_i;
    const long long qr = (long long)(i0 + it % n_i) * BT;
    stage_tile<D>(Qs(buf), q + b * q_sb + h * q_sh + qr * q_st, q_st);
    stage_tile<D>(Ds(buf), dout + b * d_sb + h * d_sh + qr * d_st, d_st);
    const long long r = ((long long)b * H + h) * T + qr;
    if (threadIdx.x < BT / 4)
      cp_async16(Ls(buf) + threadIdx.x * 4, lse + r + threadIdx.x * 4);
    else if (threadIdx.x < BT / 2)
      cp_async16(Es(buf) + (threadIdx.x - BT / 4) * 4,
                 delta + r + (threadIdx.x - BT / 4) * 4);
    cp_async_commit();
  };

  stage_tile<D>(Ks, k + b * k_sb + kvh * k_sh + k0 * k_st, k_st);
  stage_tile<D>(Vs, v + b * v_sb + kvh * v_sh + k0 * v_st, v_st);
  issue(0, 0);  // commits K, V and the first (Q, dO) pair as one group

  float dka[ND][4], dva[ND][4];  // rows g, g+8 x cols nt*8 + c2 + {0,1}
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      issue(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool diag = causal && i0 + it % n_i == j;
    const bf16* Qt = Qs(buf);
    const bf16* Dt = Ds(buf);
    const float* lt = Ls(buf);
    const float* et = Es(buf);

    for (int c0 = 0; c0 < BT; c0 += CH) {
      // S^T = K Q^T and dP^T = V dO^T: [16 kv rows x CH q columns]
      float st[NC][4], dpt[NC][4];
#pragma unroll
      for (int nt = 0; nt < NC; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, Ks + (r0 + lr + (lm % 2) * 8) * LD + kk * 16 +
                            (lm / 2) * 8);
        ldmatrix_x4(va, Vs + (r0 + lr + (lm % 2) * 8) * LD + kk * 16 +
                            (lm / 2) * 8);
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          uint32_t qf[4], df[4];  // b0,b1 of q tiles 2np and 2np+1
          const int row = c0 + (2 * np + lm / 2) * 8 + lr;
          ldmatrix_x4(qf, Qt + row * LD + kk * 16 + (lm % 2) * 8);
          ldmatrix_x4(df, Dt + row * LD + kk * 16 + (lm % 2) * 8);
          mma_bf16(st[2 * np], ka, qf[0], qf[1]);
          mma_bf16(st[2 * np + 1], ka, qf[2], qf[3]);
          mma_bf16(dpt[2 * np], va, df[0], df[1]);
          mma_bf16(dpt[2 * np + 1], va, df[2], df[3]);
        }
      }

      // P^T and dS^T, rounded to bf16 as the A operands of the products below
      uint32_t pa[CH / 16][4], dsa[CH / 16][4];
#pragma unroll
      for (int nt = 0; nt < NC; ++nt) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + nt * 8 + c2 + (e & 1);  // q row in its tile
          const int row = r0 + g + (e >> 1) * 8;       // kv row in its tile
          float pe = __expf(st[nt][e] * scale - lt[col]);
          if (diag && col < row) pe = 0.f;  // key after the query: masked
          p[e] = pe;
          ds[e] = pe * (dpt[nt][e] - et[col]) * scale;
        }
        pa[nt / 2][(nt % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsa[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q over this chunk's q rows
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t df[4], qf[4];  // b0,b1 of d tiles 2np and 2np+1
          const int row = c0 + kk * 16 + (lm % 2) * 8 + lr;
          ldmatrix_x4_trans(df, Dt + row * LD + (2 * np + lm / 2) * 8);
          ldmatrix_x4_trans(qf, Qt + row * LD + (2 * np + lm / 2) * 8);
          mma_bf16(dva[2 * np], pa[kk], df[0], df[1]);
          mma_bf16(dva[2 * np + 1], pa[kk], df[2], df[3]);
          mma_bf16(dka[2 * np], dsa[kk], qf[0], qf[1]);
          mma_bf16(dka[2 * np + 1], dsa[kk], qf[2], qf[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

  store_rows<D>(dk + b * dk_sb + kvh * dk_sh + k0 * dk_st, dk_st, dka, r0, g,
                c2);
  store_rows<D>(dv + b * dv_sb + kvh * dv_sh + k0 * dv_st, dv_st, dva, r0, g,
                c2);
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
  const size_t smem = Cfg<D>::tiles_bytes + sizeof(float) * 4 * BT;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(T / BT, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv, T,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
      scale, causal);
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
// [B, Hkv, T, D]. T must be a multiple of 64 and D 64 or 128. Returns the
// CUDA error code of the launch (0 = success).
int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int H, int Hkv, int T, int D,
                                 const long long* strides, float scale,
                                 int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                                T, strides, scale, causal, s);
  if (D == 64)
    return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                               T, strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
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
