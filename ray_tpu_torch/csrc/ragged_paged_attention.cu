// Ragged paged decode attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces the TPU kernel ray_tpu/ops/ragged_paged_attention.py::_ragged_kernel
// (launched by _ragged_kernel_call). Same function: one decode token per row
// attends over exactly the pages its block-table row names, at cache
// positions <= pos[b], with an f32 online softmax; pages whose first
// position is past pos[b] contribute nothing, out-of-range page ids clamp
// into the pool, and the output is acc / max(l, 1e-30).
//
// What bounds it on the H100: decode attention does ~2 FLOPs per byte of
// K/V it reads, far below the ridge, so HBM bandwidth bounds it: at the
// serving shape (B=8, Hkv=8, Dh=128, P=64) a row with 32 live pages reads
// 4 MB of K and V, and all eight rows full read 67.1 MB, 0.020 ms at
// 3.35 TB/s. The card reaches that rate only with many SMs each keeping
// several pages in flight.
//
// Design (flash-decoding): two kernels, both launched by the one C entry
// point, which returns the first CUDA error.
// - Split pass, grid (split, kv head, row). The host picks the split count
//   S and the pages per split pps from (B, Hkv, nb) and the SM count alone
//   (ops/ragged_paged_attention.py::ragged_splits), so the decode step
//   needs no device-to-host read. Split s of row b walks the live pages
//   [s * pps, min((s + 1) * pps, live_b)), live_b = min(nb, pos[b] / P + 1)
//   read on the device; a split that starts past live_b writes an empty
//   partial (m = -1e30, l = 0) and exits.
// - Bytes in flight: the CTA copies each page's K and V slices [P, Dh] with
//   16-byte cp.async into a three-stage ring of padded shared-memory rows,
//   two pages ahead of the one it computes.
// - Products on the tensor cores: P / 16 warps each own 16 keys of every
//   page. S = Q K^T and O += P V are mma.sync m16n8k16 (mma_tiles.cuh) with
//   the G <= 8 query rows of the kv head padded to 16; K is read with
//   ldmatrix and V with ldmatrix.trans from the padded rows (conflict-free).
//   Each warp keeps its own f32 online softmax (m, l in log2 units) and O
//   accumulator, so a page needs no block-wide barrier beyond the ring's.
//   The first version (one CTA per row and kv head with one page in
//   flight, and an f32 FMA loop in which each thread walked Dh per (query,
//   key) pair out of shared memory) reached 4 % of its byte bound.
// - At the end of a split its warps merge their partials through shared
//   memory and write one partial O [G, Dh] (f32, not normalised), m and l.
// - Merge pass, one CTA per (row, kv head): M = max_s m_s,
//   L = sum_s l_s 2^(m_s - M), O = sum_s o_s 2^(m_s - M) / max(L, 1e-30),
//   written as bf16; an empty split (l = 0) weighs 0. The weights are
//   formed once in shared memory, so the loads of the partial O do not
//   wait on one another: with a loop of dependent loads the merge took up
//   to 8.5 us of a call, now up to 4.7 (chip_smoke.py, NVIDIA H100 80GB
//   HBM3, 700 W).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;
using hopper_tiles::exp2_approx;
using bf16 = __nv_bfloat16;

constexpr int MAX_G = 8;
constexpr int STAGES = 3;          // pages in the ring: two in flight
constexpr float NEG_INF = -1e30f;  // ray_tpu's _NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

template <int DH, int P>
struct Split {
  static constexpr int NW = P / 16;             // warps, 16 keys of a page each
  static constexpr int THREADS = NW * 32;
  static constexpr int LD = DH + 8;             // padded bf16 row
  static constexpr int SLICE = P * LD;          // one K or V page slice
  static constexpr size_t smem = sizeof(bf16) * STAGES * 2 * SLICE;
  // the warps' partials reuse the ring at the end
  static_assert(sizeof(float) * NW * MAX_G * (DH + 2) <= smem, "merge scratch");
};

__device__ __forceinline__ uint32_t ld_bf16x2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH, int P>
__global__ void __launch_bounds__(Split<DH, P>::THREADS)
ragged_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                    const bf16* __restrict__ vp, const int* __restrict__ tbl,
                    const int* __restrict__ pos, float* __restrict__ o_part,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    int Hkv, int G, int nb, int pps, long long tbl_stride,
                    int num_pages, float scale) {
  using C = Split<DH, P>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;          // this lane's query row (rows 8-15 pad)
  const int c2 = (lane % 4) * 2;
  const int lm = lane / 8;
  const int lr = lane % 8;

  const int p0 = pos[b];
  const int live = p0 < 0 ? 0 : min(nb, p0 / P + 1);
  const int first = split * pps;
  const int n = min(pps, live - first);  // pages of this split
  // (row, kv head, split, query head 0) in the [B, Hkv, S, G] partials
  const long long part = (((long long)b * Hkv + kvh) * gridDim.x + split) * G;
  if (n <= 0) {
    if (threadIdx.x < G) {
      m_part[part + threadIdx.x] = NEG_INF;
      l_part[part + threadIdx.x] = 0.f;
    }
    return;
  }
  const int* row_tbl = tbl + b * tbl_stride;
  const long long tok = (long long)Hkv * DH;  // pool elements per key

  // page first + i into ring stage i % STAGES; a commit group either way,
  // so the wait below counts pages
  auto issue = [&](int i) {
    if (i < n) {
      const int page = min(max(row_tbl[first + i], 0), num_pages - 1);
      const long long off = ((long long)page * P * Hkv + kvh) * DH;
      bf16* kd = ring + (2 * (i % STAGES)) * C::SLICE;
      load_tile_async<P, DH, C::LD, C::THREADS>(kd, kp + off, tok);
      load_tile_async<P, DH, C::LD, C::THREADS>(kd + C::SLICE, vp + off, tok);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  // Q as the A operand of S = Q K^T: row g < G is query head g of this kv
  // head, the other rows are zero
  uint32_t qf[DH / 16][4];
  const bf16* qg = q + (((long long)b * Hkv + kvh) * G + min(g, G - 1)) * DH;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    qf[kk][0] = g < G ? ld_bf16x2(qg + kk * 16 + c2) : 0u;
    qf[kk][1] = 0u;
    qf[kk][2] = g < G ? ld_bf16x2(qg + kk * 16 + 8 + c2) : 0u;
    qf[kk][3] = 0u;
  }

  float oacc[DH / 8][4];  // O of rows g (and pad rows g + 8), n8 tiles
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nt][e] = 0.f;
  float m = NEG_INF;  // running max of row g, log2 units
  float l = 0.f;      // this lane's part of row g's running sum
  const float sl2 = scale * LOG2E;
  const int kr = warp * 16;  // this warp's keys within a page

  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();  // page i has landed (this thread's part)
    __syncthreads();              // ... all of it; page i - 1 is done
    issue(i + STAGES - 1);        // into the stage of page i - 1
    const bf16* Kt = ring + (2 * (i % STAGES)) * C::SLICE;
    const bf16* Vt = Kt + C::SLICE;

    // S = Q K^T over the warp's 16 keys: two n8 tiles
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t kf[4];
      ldmatrix_x4(kf, Kt + (kr + (lm / 2) * 8 + lr) * C::LD + kk * 16 +
                          (lm % 2) * 8);
      mma_bf16(sc[0], qf[kk], kf[0], kf[1]);
      mma_bf16(sc[1], qf[kk], kf[2], kf[3]);
    }

    // online softmax of row g over these keys; masked past the position
    const int key0 = (first + i) * P + kr;
    float mx = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s = key0 + nt * 8 + c2 + e <= p0 ? sc[nt][e] * sl2
                                                     : NEG_INF;
        sc[nt][e] = s;
        mx = fmaxf(mx, s);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    // while every key seen so far is masked, m stays -1e30 and so must
    // the exps be zero, not 2^0
    const float m_use = m_new == NEG_INF ? 0.f : m_new;
    const float corr = exp2_approx(m - m_use);
    float rs = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = exp2_approx(sc[nt][e] - m_use);
        rs += sc[nt][e];
      }
    l = l * corr + rs;
    m = m_new;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      oacc[nt][0] *= corr;
      oacc[nt][1] *= corr;
    }

    // O += P V: P (bf16) the A operand of one k16 step, V read transposed
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), 0u,
                            pack_bf16(sc[1][0], sc[1][1]), 0u};
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, Vt + (kr + (lm % 2) * 8 + lr) * C::LD +
                                (2 * np + lm / 2) * 8);
      mma_bf16(oacc[2 * np], pa, vf[0], vf[1]);
      mma_bf16(oacc[2 * np + 1], pa, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' partials go there

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* ow = reinterpret_cast<float*>(smem);   // [NW][MAX_G][DH]
  float* mw = ow + C::NW * MAX_G * DH;          // [NW][MAX_G]
  float* lw = mw + C::NW * MAX_G;
  if (g < G) {
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
      *reinterpret_cast<float2*>(ow + (warp * MAX_G + g) * DH + nt * 8 + c2) =
          make_float2(oacc[nt][0], oacc[nt][1]);
    if (lane % 4 == 0) {
      mw[warp * MAX_G + g] = m;
      lw[warp * MAX_G + g] = l;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * DH; idx += C::THREADS) {
    const int gg = idx / DH;
    const int d = idx % DH;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < C::NW; ++w) M = fmaxf(M, mw[w * MAX_G + gg]);
    const float M_use = M == NEG_INF ? 0.f : M;
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < C::NW; ++w) {
      const float e = exp2_approx(mw[w * MAX_G + gg] - M_use);
      L += lw[w * MAX_G + gg] * e;
      O += ow[(w * MAX_G + gg) * DH + d] * e;
    }
    o_part[(part + gg) * DH + d] = O;
    if (d == 0) {
      m_part[part + gg] = M;
      l_part[part + gg] = L;
    }
  }
}

// One CTA of DH threads per (row, kv head). The splits' m and l are staged
// in shared memory and their weights 2^(m_s - M) formed once (0 for an
// empty split, which wrote no O); then thread d sums the splits' O at dim d
// with loads that do not wait on one another.
template <int DH>
__global__ void __launch_bounds__(DH)
ragged_merge_kernel(const float* __restrict__ o_part,
                    const float* __restrict__ m_part,
                    const float* __restrict__ l_part, bf16* __restrict__ out,
                    int G, int S) {
  extern __shared__ float wts[];  // [S][G] m, then weights; [S][G] l; [G] 1/L
  float* ls = wts + S * G;
  float* inv_l = ls + S * G;
  const long long p0 = (long long)blockIdx.x * S * G;  // split 0, head 0
  for (int i = threadIdx.x; i < S * G; i += DH) {
    wts[i] = m_part[p0 + i];
    ls[i] = l_part[p0 + i];
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float M = NEG_INF;
    for (int s = 0; s < S; ++s) M = fmaxf(M, wts[s * G + g]);
    const float M_use = M == NEG_INF ? 0.f : M;
    float L = 0.f;
    for (int s = 0; s < S; ++s) {
      const float l = ls[s * G + g];
      const float e = l > 0.f ? exp2_approx(wts[s * G + g] - M_use) : 0.f;
      wts[s * G + g] = e;
      L += l * e;
    }
    inv_l[g] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const int d = threadIdx.x;
  for (int g = 0; g < G; ++g) {
    float O = 0.f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const float e = wts[s * G + g];
      const float o = o_part[(p0 + s * G + g) * DH + d];
      O = fmaf(e, e != 0.f ? o : 0.f, O);  // unwritten O of an empty split
    }
    out[((long long)blockIdx.x * G + g) * DH + d] =
        __float2bfloat16(O * inv_l[g]);
  }
}

template <int DH, int P>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tbl, const void* pos, void* out, void* o_part,
                   void* m_part, void* l_part, int B, int Hkv, int G, int nb,
                   int S, int pps, long long tbl_stride, int num_pages,
                   float scale, cudaStream_t stream) {
  using C = Split<DH, P>;
  if (C::smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_split_kernel<DH, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
    if (err != cudaSuccess) return err;
  }
  ragged_split_kernel<DH, P><<<dim3(S, Hkv, B), C::THREADS, C::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(tbl),
      static_cast<const int*>(pos), static_cast<float*>(o_part),
      static_cast<float*>(m_part), static_cast<float*>(l_part), Hkv, G, nb,
      pps, tbl_stride, num_pages, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ragged_merge_kernel<DH><<<B * Hkv, DH, sizeof(float) * (2 * S + 1) * G,
                            stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<bf16*>(out), G, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/out [B, Hkv, G, Dh] contiguous; kp/vp [num_pages, P, Hkv, Dh] contiguous;
// tbl [B, >=nb] int32 with row stride tbl_stride; pos [B] int32; o_part
// [B, Hkv, S, G, Dh], m_part and l_part [B, Hkv, S, G] f32 scratch. S splits
// of pps pages cover the nb pages, none starting past them. Supports Dh in
// {64, 128}, P in {16, 32, 64} and G <= 8. Launches the split pass, then the
// merge pass; returns the first CUDA error code (0 = success).
int ragged_paged_attention_bf16(const void* q, const void* kp, const void* vp,
                                const void* tbl, const void* pos, void* out,
                                void* o_part, void* m_part, void* l_part,
                                int B, int Hkv, int G, int Dh, int P, int nb,
                                int S, int pps, long long tbl_stride,
                                int num_pages, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAX_G || B < 1 || Hkv < 1 || nb < 1 || num_pages < 1 ||
      S < 1 || pps < 1 || (long long)S * pps < nb ||
      (long long)(S - 1) * pps >= nb)
    return (int)cudaErrorInvalidValue;
#define RAGGED_CASE(DH_, P_)                                                 \
  if (Dh == DH_ && P == P_)                                                  \
    return (int)launch<DH_, P_>(q, kp, vp, tbl, pos, out, o_part, m_part,    \
                                l_part, B, Hkv, G, nb, S, pps, tbl_stride,   \
                                num_pages, scale, s);
  RAGGED_CASE(128, 64)
  RAGGED_CASE(128, 32)
  RAGGED_CASE(128, 16)
  RAGGED_CASE(64, 64)
  RAGGED_CASE(64, 32)
  RAGGED_CASE(64, 16)
#undef RAGGED_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
