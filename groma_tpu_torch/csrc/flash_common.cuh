// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the bf16 tensor-core product, its fragment
// loads, and the staging of kv / q tiles into shared memory.
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
constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

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

// A fragments of the 16 rows `row[0]`, `row[1]` = row[0] + 8 of a
// (S, D) row-major matrix in device memory, rows >= S read as 0.
template <int D>
__device__ __forceinline__ void load_a_global(uint32_t (*a)[4],
                                              const bf16* base,
                                              const int* row, int S,
                                              int tig) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * tig;
    a[kc][0] = row[0] < S ? ld32(base + (size_t)row[0] * D + c) : 0u;
    a[kc][1] = row[1] < S ? ld32(base + (size_t)row[1] * D + c) : 0u;
    a[kc][2] = row[0] < S ? ld32(base + (size_t)row[0] * D + c + 8) : 0u;
    a[kc][3] = row[1] < S ? ld32(base + (size_t)row[1] * D + c + 8) : 0u;
  }
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

// Two C tiles (16 x 8 each, columns 16j.. and 16j+8..) -> the A fragment of
// their 16 x 16 product operand, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows r0 .. r0+R-1 of a (S, D) row-major matrix -> dst[R][P], 16 bytes a
// thread per step (coalesced); rows >= S become 0.
template <int D, int R, int P>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int r0, int S, int tid) {
  for (int idx = tid; idx < R * (D / 8); idx += kThreads) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D
                                                 + c));
    *reinterpret_cast<uint4*>(dst + r * P + c) = val;
  }
}

// Rows r0 .. r0+R-1 of a (S, D) row-major matrix -> transposed dst[D][P]
// (dst[c][r] = src[r0 + r][c]); rows >= S become 0.  A thread moves two
// rows of 8 columns and writes 32-bit pairs; the 32 lanes of a warp take
// 32 consecutive row pairs, so their stores hit 32 consecutive words.
template <int D, int R, int P>
__device__ __forceinline__ void stage_transposed(bf16* dst, const bf16* src,
                                                 int r0, int S, int tid) {
  for (int idx = tid; idx < (R / 2) * (D / 8); idx += kThreads) {
    const int rp = idx % (R / 2), c = (idx / (R / 2)) * 8;
    const int r = r0 + 2 * rp;
    uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
    if (r < S)
      v0 = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * D + c));
    if (r + 1 < S)
      v1 = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r + 1) * D
                                                + c));
    const bf16* e0 = reinterpret_cast<const bf16*>(&v0);
    const bf16* e1 = reinterpret_cast<const bf16*>(&v1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      __nv_bfloat162 pr;
      pr.x = e0[i];
      pr.y = e1[i];
      *reinterpret_cast<__nv_bfloat162*>(dst + (c + i) * P + 2 * rp) = pr;
    }
  }
}

}  // namespace flash
