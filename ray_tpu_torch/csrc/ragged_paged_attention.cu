// Ragged paged decode attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces the TPU kernel ray_tpu/ops/ragged_paged_attention.py::_ragged_kernel
// (launched by _ragged_kernel_call). Same function: one decode token per row
// attends over exactly the pages its block-table row names, at cache
// positions <= pos[b], with an f32 online softmax carried page by page; pages
// whose first position is past pos[b] are skipped.
//
// Design.
// - One CTA per (row b, kv head). The CTA reads pos[b] and its block-table
//   row itself (this replaces the TPU's scalar prefetch) and walks only the
//   live pages: min(nb, pos[b] / P + 1) of them. Dead pages cost nothing.
// - The G query heads that share the kv head are handled together, so each
//   K/V page slice [P, Dh] is read from the pool once per CTA.
// - One thread per head-dim lane (Dh threads). Each page's K and V slices are
//   gathered from the pool with 16-byte loads into registers one page ahead
//   (software prefetch) and staged through shared memory. Scores: each
//   thread owns (g, p) dot products over the padded K rows (conflict-free
//   row stride). Softmax: one warp per query head. P.V: each thread owns one
//   output dim for all G heads in f32 registers. Both products are plain
//   f32 FMAs, not tensor-core MMAs: with G = 4 query rows per kv head there
//   is no 16-row tile to fill, and the kernel is bound by bytes anyway.
// - Out-of-range page ids clamp into the pool, as the TPU gather does.
//
// What bounds it on the H100: decode attention does ~2 FLOPs per byte of
// K/V it reads, far below the ridge, so HBM bandwidth bounds it. The known
// limit of this first version is occupancy: B * Hkv CTAs (64 at the serving
// shape B=8, Hkv=8) for 132 SMs, each walking its pages in turn. The next
// step is to split the page sweep across CTAs and merge partials by lse
// (flash-decoding), recorded in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_G = 8;
constexpr float NEG_INF = -1e30f;  // ray_tpu's _NEG_INF

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dh threads; P keys per page; LOADS = 16-byte loads per thread per slice
template <int DH, int P>
struct Cfg {
  static constexpr int CHUNKS = DH / 8;                // uint4 per row
  static constexpr int LOADS = P * CHUNKS / DH;        // per thread per slice
  static constexpr int LDK = DH + 2;                   // bf16 padded K row
  static_assert((P * CHUNKS) % DH == 0, "page slice must split evenly");
};

template <int DH, int P>
__global__ void __launch_bounds__(DH)
ragged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ kp,
                     const __nv_bfloat16* __restrict__ vp,
                     const int* __restrict__ tbl, const int* __restrict__ pos,
                     __nv_bfloat16* __restrict__ out, int Hkv, int G, int nb,
                     long long tbl_stride, int num_pages, float scale) {
  using C = Cfg<DH, P>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);      // [P][LDK]
  __nv_bfloat16* Vs = Ks + P * C::LDK;                              // [P][DH]
  float* qs = reinterpret_cast<float*>(Vs + P * DH);                // [G][DH]
  float* ss = qs + G * DH;                                          // [G][P]
  float* m_s = ss + G * P;                                          // [G]
  float* l_s = m_s + G;                                             // [G]
  float* c_s = l_s + G;                                             // [G]

  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  constexpr int NWARPS = DH / 32;

  const int p0 = pos[b];
  const int live = min(nb, p0 / P + 1);
  const int* row_tbl = tbl + b * tbl_stride;
  const long long qoff = ((long long)b * Hkv + kvh) * G * DH;
  const long long tok_stride = (long long)Hkv * DH;  // pool stride per key

  for (int g = 0; g < G; ++g)
    qs[g * DH + t] = __bfloat162float(q[qoff + g * DH + t]) * scale;
  if (t < G) {
    m_s[t] = NEG_INF;
    l_s[t] = 0.f;
  }

  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;

  uint4 kreg[C::LOADS], vreg[C::LOADS];
  auto fetch = [&](int j) {
    int page = row_tbl[j];
    page = min(max(page, 0), num_pages - 1);
    const __nv_bfloat16* kbase = kp + ((long long)page * P * Hkv + kvh) * DH;
    const __nv_bfloat16* vbase = vp + ((long long)page * P * Hkv + kvh) * DH;
#pragma unroll
    for (int i = 0; i < C::LOADS; ++i) {
      const int idx = t + i * DH;
      const int r = idx / C::CHUNKS;
      const int c = idx % C::CHUNKS;
      kreg[i] = *reinterpret_cast<const uint4*>(kbase + r * tok_stride + c * 8);
      vreg[i] = *reinterpret_cast<const uint4*>(vbase + r * tok_stride + c * 8);
    }
  };

  if (live > 0) fetch(0);
  for (int j = 0; j < live; ++j) {
    __syncthreads();  // previous page's smem reads are done
#pragma unroll
    for (int i = 0; i < C::LOADS; ++i) {
      const int idx = t + i * DH;
      const int r = idx / C::CHUNKS;
      const int c = idx % C::CHUNKS;
      // padded K rows take 4-byte stores (row stride is not 16-byte aligned)
      uint32_t* kd = reinterpret_cast<uint32_t*>(Ks + r * C::LDK + c * 8);
      kd[0] = kreg[i].x;
      kd[1] = kreg[i].y;
      kd[2] = kreg[i].z;
      kd[3] = kreg[i].w;
      *reinterpret_cast<uint4*>(Vs + r * DH + c * 8) = vreg[i];
    }
    __syncthreads();
    if (j + 1 < live) fetch(j + 1);  // in flight while this page computes

    // scores: thread owns (g, p) pairs; masked past the row's position
    for (int idx = t; idx < G * P; idx += DH) {
      const int g = idx / P;
      const int p = idx % P;
      const __nv_bfloat162* kr =
          reinterpret_cast<const __nv_bfloat162*>(Ks + p * C::LDK);
      const float* qg = qs + g * DH;
      float s = 0.f;
#pragma unroll 8
      for (int d2 = 0; d2 < DH / 2; ++d2) {
        const float2 kf = __bfloat1622float2(kr[d2]);
        s = fmaf(qg[2 * d2], kf.x, s);
        s = fmaf(qg[2 * d2 + 1], kf.y, s);
      }
      ss[g * P + p] = (j * P + p <= p0) ? s : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += NWARPS) {
      float mx = NEG_INF;
      for (int p = lane; p < P; p += 32) mx = fmaxf(mx, ss[g * P + p]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int p = lane; p < P; p += 32) {
        const float e = __expf(ss[g * P + p] - m_new);
        ss[g * P + p] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = __expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // P.V: thread t owns output dim t for every query head
    float pv[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) pv[g] = 0.f;
    for (int p = 0; p < P; ++p) {
      const float vf = __bfloat162float(Vs[p * DH + t]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) pv[g] = fmaf(ss[g * P + p], vf, pv[g]);
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) acc[g] = acc[g] * c_s[g] + pv[g];
  }
  __syncthreads();

#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G)
      out[qoff + g * DH + t] =
          __float2bfloat16(acc[g] / fmaxf(l_s[g], 1e-30f));
}

template <int DH, int P>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tbl, const void* pos, void* out, int B,
                   int Hkv, int G, int nb, long long tbl_stride,
                   int num_pages, float scale, cudaStream_t stream) {
  using C = Cfg<DH, P>;
  const size_t smem = sizeof(__nv_bfloat16) * (P * C::LDK + P * DH) +
                      sizeof(float) * (G * DH + G * P + 3 * G);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_decode_kernel<DH, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  ragged_decode_kernel<DH, P><<<B * Hkv, DH, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(tbl),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), Hkv, G,
      nb, tbl_stride, num_pages, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/out [B, Hkv, G, Dh] contiguous; kp/vp [num_pages, P, Hkv, Dh] contiguous;
// tbl [B, >=nb] int32 with row stride tbl_stride; pos [B] int32. Supports
// Dh in {64, 128}, P in {16, 32, 64} and G <= 8. Returns the CUDA error code
// of the launch (0 = success).
int ragged_paged_attention_bf16(const void* q, const void* kp, const void* vp,
                                const void* tbl, const void* pos, void* out,
                                int B, int Hkv, int G, int Dh, int P, int nb,
                                long long tbl_stride, int num_pages,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAX_G) return (int)cudaErrorInvalidValue;
#define RAGGED_CASE(DH_, P_)                                                 \
  if (Dh == DH_ && P == P_)                                                  \
    return (int)launch<DH_, P_>(q, kp, vp, tbl, pos, out, B, Hkv, G, nb,     \
                                tbl_stride, num_pages, scale, s);
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
