// Building blocks of the ragged decode kernel's split pass (sm_90a): 16-byte
// cp.async copies into padded shared memory, ldmatrix fragment loads and
// the mma.sync m16n8k16 bf16 product with f32 accumulation. With G <= 8
// query rows per kv head there is no 64-row wgmma tile to fill. The flash
// kernels use hopper_tiles.cuh (TMA, mbarriers, wgmma).
//
// Fragment conventions (PTX ISA, mma.m16n8k16 with .bf16): for lane l,
// g = l / 4 and c2 = (l % 4) * 2. An accumulator c[4] holds rows g (c[0..1])
// and g + 8 (c[2..3]) at columns c2, c2 + 1 of its 16 x 8 tile. An A operand
// a[4] holds a 16 x 16 tile: a[0] rows 0-7 / k 0-7, a[1] rows 8-15 / k 0-7,
// a[2] rows 0-7 / k 8-15, a[3] rows 8-15 / k 8-15. A pair of n8 accumulator
// tiles therefore repacks, rounded to bf16, into one A operand in registers.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tiles {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ROWS x D bf16 tile from global (row stride `st` elements) into shared
// memory (row stride LD) with 16-byte cp.async copies spread over NTHREADS
template <int ROWS, int D, int LD, int NTHREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long st) {
  constexpr int CHUNKS = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    cp_async16(dst + r * LD + c * 8, src + r * st + c * 8);
  }
}

}  // namespace mma_tiles
