// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 O + f32 lse out.
//
// Replaces the TPU kernel ray_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd_call). Same function: blocked online-softmax attention,
// causal or full, over heads-major q/k/v, writing O in the input dtype and the
// per-row logsumexp in f32.
//
// What bounds it on the H100: 4*D FLOPs per live (query, key) pair against
// O(T*D*H) bytes; at the training shape [4,32,2048,64] causal that is
// 68.7 GFLOP = 0.0695 ms at 989 TFLOP/s against 0.01 ms of bytes, and at the
// prefill shape [1,32,2048,128] 0.0348 ms against 0.005 ms. The tensor cores
// bound it, and only wgmma reaches their bf16 rate; the previous version
// (mma.sync per warp, ldmatrix from padded rows, cp.async issued by the
// compute threads, two stages) reached 16-18 % of the bound.
//
// Design (hopper_tiles.cuh has the building blocks).
// - One CTA of three warpgroups per (q tile of 128 rows, head, batch). CTAs
//   are issued heaviest (last q tile) first across all heads and batches,
//   so the causal triangle load-balances. GQA in the kernel: head h reads kv head h / (H / Hkv).
// - Warpgroup 0 is the producer: one thread issues TMA loads of the Q tile
//   and a ring of STAGES (K, V) tiles of 128 keys into 128-byte swizzled
//   shared memory; each stage has a full and an empty mbarrier. It gives
//   registers away with setmaxnreg (40 a thread).
// - Warpgroups 1 and 2 are consumers of 64 query rows each (232 registers a
//   thread). Per kv tile: S = Q K^T by wgmma m64n128k16 with both operands
//   in shared memory; the online softmax in registers (exp2, row max and sum
//   within quads of lanes); P rounded to bf16 in registers and fed as the
//   register A operand of O += P V, with V the MN-major B operand
//   (m64n64k16, one per 64 columns of D). Then each consumer warp arrives on
//   the stage's empty barrier.
// - Softmax and products overlap two ways. Inside a warpgroup, S_j and
//   P_{j-1} V_{j-1} are issued together and the softmax of S_j runs while
//   P_{j-1} V_{j-1} is on the tensor cores. Between the warpgroups, a pair
//   of named barriers makes them take turns issuing, so one's softmax runs
//   under the other's products. Exp throughput (16 a clock per SM) is what
//   makes this matter: at D = 64 a tile's exps take as long as its products.
// - The kernel's tile is 128 rows, the callers' rule is T % 64 == 0: a
//   half tile at the end is zero-filled by TMA, its keys >= T are masked,
//   and no row >= T is stored.
// - The activations are [B,T,H,D] transposed views; the tensor maps take
//   their strides as they are, so nothing is copied.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

using namespace hopper_tiles;
using bf16 = __nv_bfloat16;

constexpr int BQ = 128;       // query rows per CTA, 64 per consumer warpgroup
constexpr int BK = 128;       // keys per kv tile
constexpr int NTHREADS = 384; // producer warpgroup + two consumer warpgroups
constexpr float NEG_INF = -1e30f;  // ray_tpu's _NEG_INF: masked scores
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Fwd {
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // barriers, then slack to align the base to 1024 bytes
  static constexpr size_t smem = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

// Online softmax of one kv tile, S in the wgmma accumulator layout (raw
// scores): masks keys >= T and (causal) keys after the row on the edge
// tile, updates the running max m_r (log2 units) and partial sums l_r,
// returns O's rescale in corr and P (f32) in sacc.
__device__ __forceinline__ void softmax_tile(float (&sacc)[64],
                                             float (&m_r)[2], float (&l_r)[2],
                                             float (&corr)[2], bool edge,
                                             int j, int T, int causal,
                                             int row0, int c2, float sl2) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (edge) {
      const int key = j * BK + (i / 4) * 8 + c2 + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      if (key >= T || (causal && key > row)) sacc[i] = NEG_INF;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r] * sl2);
    corr[r] = exp2_approx(m_r[r] - m_new);
    m_r[r] = m_new;
    l_r[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float e = exp2_approx(fmaf(sacc[i], sl2, -m_r[(i >> 1) & 1]));
    l_r[(i >> 1) & 1] += e;
    sacc[i] = e;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ o, float* __restrict__ lse,
                 int H, int Hkv, int T,
                 long long o_sb, long long o_sh, long long o_st,
                 float scale, int causal) {
  using F = Fwd<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qs = base;
  auto ks = [&](int s) { return base + F::Q_BYTES + s * F::STAGE_BYTES; };
  auto vs = [&](int s) { return ks(s) + F::KV_BYTES; };
  const uint32_t bars = base + F::BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (F::STAGES + s); };
  const uint32_t q_full = bars + 8 * 2 * F::STAGES;
  static_assert(F::smem <= 232448, "shared memory of one CTA");

  // CTAs start in blockIdx order, x fastest: every (head, batch) of the
  // heaviest causal q tile first, the four q heads of a kv group side by
  // side (they read the same K/V from L2)
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qi = gridDim.z - 1 - blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q0 = qi * BQ;
  // BQ == BK: the diagonal tile is qi
  const int n_kv = causal ? qi + 1 : (T + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F::STAGES; ++s) {
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
      mbar_expect_tx(q_full, F::Q_BYTES);
      tma_tile<D, BQ>(qs, &tq, q_full, q0, h, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % F::STAGES;
        mbar_wait(empty(s), ((j / F::STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), F::STAGE_BYTES);
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
    const float sl2 = scale * LOG2E;   // scores in log2 units
    const uint32_t qa = qs + cw * 64 * 128;
    const int row0 = q0 + cw * 64 + w * 16 + g;  // rows row0, row0 + 8

    float oacc[D / 64][32];  // O: 64-column blocks, wgmma accumulator layout
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[nb][i] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF};  // running max (log2 units)
    float l_r[2] = {0.f, 0.f};          // this lane's partial running sums
    float corr[2];                      // rescale of O for the newest tile
    float sacc[64];                     // S of the newest kv tile
    uint32_t pf[BK / 16][4];            // P of the tile before (A operand)

    // S_j = Q K_j^T into sacc. Each product pins its registers' last
    // writes before its fence, so ptxas need not inject one of its own.
    auto issue_s = [&](int s) {
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(sacc,
                      desc_sw128(qa + (kk / 4) * BQ * 128 + (kk % 4) * 32),
                      desc_sw128(ks(s) + (kk / 4) * BK * 128 + (kk % 4) * 32),
                      kk > 0);
      wgmma_commit();
    };
    // O += P_j V_j from pf
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb) fence_regs(oacc[nb]);
      fence_regs(pf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int nb = 0; nb < D / 64; ++nb)
          wgmma_rs_n64(oacc[nb], pf[kk],
                       desc_sw128(vs(s) + nb * BK * 128 + kk * 2048), 1);
      wgmma_commit();
    };
    // P V done: this warp is done with stage s
    auto release = [&](int s) {
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb) fence_regs(oacc[nb]);
      fence_regs(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };

    // Turn 0 issues S_0; turn j (0 < j < n_kv) issues S_j and
    // P_{j-1} V_{j-1} as two commit groups, and the softmax of S_j runs
    // while P_{j-1} V_{j-1} is on the tensor cores; turn n_kv issues the
    // last P V. P_j stays in f32 in sacc until P_{j-1} V_{j-1} is done and
    // only then becomes pf, and O is rescaled just before the P V that
    // needs it: no register a running wgmma reads is written under it
    // (else ptxas serialises every wgmma). The warpgroups also take turns
    // issuing (named barriers 1 and 2), so one's softmax runs under the
    // other's products.
    auto rescale_o = [&]() {
#pragma unroll
      for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) oacc[nb][i] *= corr[(i >> 1) & 1];
    };
    if (cw == 1) bar_arrive(1, 256);  // warpgroup 1 goes first
    mbar_wait(q_full, 0);
    mbar_wait(full(0), 0);
    bar_sync(1 + cw, 256);
    issue_s(0);
    bar_arrive(2 - cw, 256);
    wgmma_wait<0>();
    fence_regs(sacc);
    softmax_tile(sacc, m_r, l_r, corr, n_kv == 1, 0, T, causal, row0, c2,
                 sl2);
    acc_to_frags<BK>(sacc, pf);
    for (int j = 1; j < n_kv; ++j) {
      const int s = j % F::STAGES;
      const int sp = (j - 1) % F::STAGES;
      mbar_wait(full(s), (j / F::STAGES) & 1);
      bar_sync(1 + cw, 256);
      issue_s(s);
      rescale_o();
      issue_pv(sp);
      bar_arrive(2 - cw, 256);
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
      fence_regs(sacc);
      softmax_tile(sacc, m_r, l_r, corr, j == n_kv - 1, j, T, causal, row0,
                   c2, sl2);
      release(sp);
      acc_to_frags<BK>(sacc, pf);
    }
    bar_sync(1 + cw, 256);
    rescale_o();
    issue_pv((n_kv - 1) % F::STAGES);
    if (cw == 0) bar_arrive(2, 256);  // the last turn of all
    release((n_kv - 1) % F::STAGES);

    // finalize: full row sums across the quad, O / l in bf16, lse in f32
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
      const float l = fmaxf(l_r[r], 1e-30f);
      const float inv = 1.f / l;
      const int row = q0 + cw * 64 + w * 16 + g + r * 8;
      if (row < T) {
        bf16* orow = o + b * o_sb + h * o_sh + (long long)row * o_st;
#pragma unroll
        for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
          for (int jt = 0; jt < 8; ++jt)
            *reinterpret_cast<__nv_bfloat162*>(orow + nb * 64 + jt * 8 + c2) =
                __floats2bfloat162_rn(oacc[nb][4 * jt + 2 * r] * inv,
                                      oacc[nb][4 * jt + 2 * r + 1] * inv);
        if (lane % 4 == 0)
          lse[((long long)b * H + h) * T + row] = m_r[r] * LN2 + logf(l);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Hkv, int T,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_rows(&tq, q, B, H, T, D, st[0], st[1], st[2], BQ) ||
      !encode_rows(&tk, k, B, Hkv, T, D, st[3], st[4], st[5], BK) ||
      !encode_rows(&tv, v, B, Hkv, T, D, st[6], st[7], st[8], BK))
    return cudaErrorInvalidValue;
  const size_t smem = Fwd<D>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (T + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), H, Hkv, T,
      st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 int64 element strides (batch, head, time) for q, k, v, o;
// lse is a contiguous [B, H, T] f32 buffer. T must be a multiple of 64 and
// D 64 or 128. Device pointers and layouts are checked before any tensor
// map is encoded. Returns the CUDA error code of the launch (0 = success).
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Hkv, int T,
                             int D, const long long* strides, float scale,
                             int causal, void* stream) {
  const long long* st = strides;
  const void* rows[4] = {q, k, v, o};
  if ((D != 64 && D != 128) || T <= 0 || T % 64 || B <= 0 || Hkv <= 0 ||
      H % Hkv)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (!on_device(rows[i]) ||
        !rows_layout_ok(rows[i], st[3 * i], st[3 * i + 1], st[3 * i + 2]))
      return (int)cudaErrorInvalidValue;
  if (!on_device(lse)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch<128>(q, k, v, o, lse, B, H, Hkv, T, st, scale, causal,
                            s);
  return (int)launch<64>(q, k, v, o, lse, B, H, Hkv, T, st, scale, causal, s);
}

}  // extern "C"
