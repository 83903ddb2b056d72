// The bf16 mma.sync tensor-core product and its fragment loads, for the
// kernels that run it: int4_matmul.cu (the prefill tile) and
// probe_int4_unpack.cu (probe C).  The flash-attention kernels, whose
// first versions gave this header its name, moved to wgmma
// (sm90_common.cuh).
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, f32):        c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1)
// Each 32-bit register holds two bf16, the lower index in the low half, so
// every fragment is read with 32-bit loads from a row-major tile whose rows
// are the fragment's rows (A) or its n index (B).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment at rows r, r+8 and columns c.., c+8.. of a shared tile.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile,
                                       int pitch, int r, int c) {
  a[0] = ld32(tile + r * pitch + c);
  a[1] = ld32(tile + (r + 8) * pitch + c);
  a[2] = ld32(tile + r * pitch + c + 8);
  a[3] = ld32(tile + (r + 8) * pitch + c + 8);
}

// B fragment whose n index is row `n` of a shared tile, k at columns c...
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* tile,
                                       int pitch, int n, int c) {
  b[0] = ld32(tile + n * pitch + c);
  b[1] = ld32(tile + n * pitch + c + 8);
}

}  // namespace flash
