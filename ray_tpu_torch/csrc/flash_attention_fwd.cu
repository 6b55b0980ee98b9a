// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 O + f32 lse out.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd_call). Same function: blocked online-softmax attention,
// causal or full, over heads-major q/k/v, writing O in the input dtype and the
// per-row logsumexp in f32.
//
// Design.
// - One CTA of 4 warps per (q tile of 64 rows, head, batch); each warp owns
//   16 query rows. The TPU kernel's sequential kv grid axis becomes a loop
//   inside the CTA; it stops at the diagonal tile when causal, so tiles above
//   the diagonal cost nothing. CTAs are issued heaviest (last q tile) first so
//   the causal triangle load-balances.
// - GQA in the kernel: head h reads kv head h / (H / Hkv), so the card path
//   never materialises repeat_kv's copy.
// - Any strides with a unit last dim: the dispatcher passes [B,T,H,D]
//   activations as transposed views, no transpose copies.
// - Products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//   accumulate), operands fed from shared memory by ldmatrix. Q's fragments,
//   the S = Q K^T tile, the running max/sum and the O accumulator all stay in
//   registers; P is rounded to bf16 in registers and reused directly as the
//   A operand of O += P V (as FlashAttention-2 does). The row max and sum
//   need only shuffles within a quad of lanes.
// - K/V tiles are double-buffered with cp.async: tile j+1 streams in while
//   tile j computes.
//
// What bounds it on the H100: at the prefill shapes (H=32, D=128, T>=1024)
// the work is 4*T^2*D*H/2 FLOPs against O(T*D*H) bytes, far above the
// ~295 FLOP/byte ridge, so the tensor cores bound it. mma.sync cannot reach
// the bf16 peak that wgmma can (warpgroup MMA with TMA-fed tiles), which is
// the next step; see PERF.md for this version's measured share.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per kv tile
constexpr int NWARPS = 4;     // 16 query rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int NT = BK / 8;    // n8 tiles of S per warp
constexpr float NEG_INF = -1e30f;  // ray_tpu's _NEG_INF: masked scores

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // bf16 row stride: ldmatrix conflict-free
  static constexpr int TILE = BQ * LD;
  // Q, then two (K, V) buffers
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * TILE * 5;
};

// one BQ x D tile into shared memory laid out for this kernel
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long st) {
  mma_tiles::load_tile_async<BQ, D, Smem<D>::LD, NTHREADS>(dst, src, st);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Hkv, int T,
                 long long q_sb, long long q_sh, long long q_st,
                 long long k_sb, long long k_sh, long long k_st,
                 long long v_sb, long long v_sh, long long v_st,
                 long long o_sb, long long o_sh, long long o_st,
                 float scale, int causal) {
  using S = Smem<D>;
  constexpr int LD = S::LD;
  constexpr int KD = D / 16;   // k16 steps over the head dim
  constexpr int ND = D / 8;    // n8 tiles of O per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // Q, then (K, V) buffer 0, then (K, V) buffer 1
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  auto Ks = [&](int buf) { return Qs + (1 + 2 * buf) * S::TILE; };
  auto Vs = [&](int buf) { return Qs + (2 + 2 * buf) * S::TILE; };

  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = qi * BQ;
  const int r0 = warp * 16;      // this warp's rows within the tile
  const int g = lane / 4;        // accumulator row (and g + 8)
  const int c2 = (lane % 4) * 2; // accumulator column pair
  const int lm = lane / 8;       // ldmatrix: which 8x8 matrix this lane addresses
  const int lr = lane % 8;       // ldmatrix: which row of it

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh + (long long)q0 * q_st;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;
  const int n_kv = causal ? qi + 1 : T / BK;  // BQ == BK: diagonal tile = qi

  stage_tile<D>(Qs, qb, q_st);
  stage_tile<D>(Ks(0), kb, k_st);
  stage_tile<D>(Vs(0), vb, v_st);
  cp_async_commit();

  uint32_t qf[KD][4];   // Q A-fragments, loaded once
  float oacc[ND][4];    // O accumulator: rows g, g+8 x cols nt*8 + c2 + {0,1}
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
    oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // running max, rows g and g + 8
  float l_r[2] = {0.f, 0.f};          // this lane's partial running sums

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {  // prefetch the next kv tile into the other buffer
      stage_tile<D>(Ks(buf ^ 1), kb + (long long)(j + 1) * BK * k_st, k_st);
      stage_tile<D>(Vs(buf ^ 1), vb + (long long)(j + 1) * BK * v_st, v_st);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], Qs + (r0 + lr + (lm % 2) * 8) * LD + kk * 16 +
                                (lm / 2) * 8);
    }
    const __nv_bfloat16* Kt = Ks(buf);
    const __nv_bfloat16* Vt = Vs(buf);

    // S[16 x 64] = Q K^T for this warp's rows
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];  // b0,b1 of key tiles 2np and 2np+1
        ldmatrix_x4(kf, Kt + ((2 * np + lm / 2) * 8 + lr) * LD + kk * 16 +
                            (lm % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // online softmax in registers: row g uses s[.][0..1], row g+8 s[.][2..3]
    const bool diag = causal && j == qi;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (diag) {  // key column nt*8+c2+(e&1) is live iff <= query row
          const int col = nt * 8 + c2 + (e & 1);
          const int row = r0 + g + (e >> 1) * 8;
          if (col > row) x = NEG_INF;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      corr[i] = __expf(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= corr[i];
    }
    uint32_t pf[BK / 16][4];  // P as the A operand of P V
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = __expf(s[nt][0] - m_r[0]);
      const float p1 = __expf(s[nt][1] - m_r[0]);
      const float p2 = __expf(s[nt][2] - m_r[1]);
      const float p3 = __expf(s[nt][3] - m_r[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pf[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int nt = 0; nt < ND; ++nt) {
      oacc[nt][0] *= corr[0];
      oacc[nt][1] *= corr[0];
      oacc[nt][2] *= corr[1];
      oacc[nt][3] *= corr[1];
    }

    // O[16 x D] += P[16 x 64] V[64 x D]
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t vf[4];  // b0,b1 of d tiles 2np and 2np+1
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lm % 2) * 8 + lr) * LD +
                                  (2 * np + lm / 2) * 8);
        mma_bf16(oacc[2 * np], pf[kk], vf[0], vf[1]);
        mma_bf16(oacc[2 * np + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

  // finalize: full row sums across the quad, O / l in bf16, lse in f32
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh + (long long)q0 * o_st;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    const float l = fmaxf(l_r[i], 1e-30f);
    const float inv = 1.f / l;
    const int row = r0 + g + i * 8;
    __nv_bfloat16* orow = ob + row * o_st;
#pragma unroll
    for (int nt = 0; nt < ND; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + c2) =
          __floats2bfloat162_rn(oacc[nt][2 * i] * inv, oacc[nt][2 * i + 1] * inv);
    if (lane % 4 == 0)
      lse[((long long)b * H + h) * T + q0 + row] = m_r[i] + logf(l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hkv, int T,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(T / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Hkv, T, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 int64 element strides (batch, head, time) for q, k, v, o;
// lse is a contiguous [B, H, T] f32 buffer. T must be a multiple of 64 and
// D 64 or 128. Returns the CUDA error code of the launch (0 = success).
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Hkv, int T,
                             int D, const long long* strides, float scale,
                             int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch<128>(q, k, v, o, lse, B, H, Hkv, T, strides, scale,
                            causal, s);
  if (D == 64)
    return (int)launch<64>(q, k, v, o, lse, B, H, Hkv, T, strides, scale,
                           causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
