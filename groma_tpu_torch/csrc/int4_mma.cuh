// The packed-int4 products for weight tiles that TMA wrote into shared
// memory with the 128-byte swizzle: the fragment loads, the nibble unpack,
// and, for the decode tile, the mma.sync products of a k16 step and the
// scale fold.  Users: int4_matmul.cu (the decode tile on mma.sync with the
// batch as N, the prefill tile on wgmma with the weights as the register
// A operand) and decode_megakernel.cu (every layer matmul of the decode
// step: `step`, `load_b` and `fold`, as the decode tile calls them).
//
// The weights are the JAX package's bytes: packed (K/2, N) uint8, row k in
// the low nibble of byte (k, n) and row k + K/2 in its high nibble, each
// stored as q + 8.  A tile is 64 (decode) or 128 (prefill) packed rows x
// 128 columns (one 128-byte line a row, 1024-byte aligned); the swizzle
// stores the 16-byte chunk c of row r at chunk c ^ (r % 8).
//
// Decode: outT = W^T x^T with mma.sync.m16n8k16 bf16 -> f32
// (flash_common.cuh has the fragment layout): A is 16 weight columns x 16
// k, B is 16 k x 8 batch rows, so N = 8 is the batch and nothing is padded
// at M = 8.  The order of k and of A's 16 rows inside one product is free;
// both are chosen so that a thread's bytes are whole 32-bit words of the
// tile:
//   * k: the product's k index i is packed row i of the step (identity);
//     thread t reads rows 2t, 2t+1, 2t+8, 2t+9;
//   * A rows: in a 64-column group, n-tile j (0..3) maps row g to column
//     4g + j and row g + 8 to column 32 + 4g + j.  One 32-bit load at
//     (row, columns 4g..4g+3) serves the four n-tiles, and the 8 loads of a
//     step (4 rows x columns 4g and 32 + 4g) give every A byte of the four
//     n-tiles in both nibble halves: 8 products from 8 loads.  With the
//     swizzle, the loads of a warp hit 32 distinct banks (lanes t = 0..3
//     read rows 2t, whose chunks differ by the XOR).
//   * each byte feeds two products: its low nibble the low half's (k = r,
//     against x[:, r]) and its high nibble the high half's (k = K/2 + r,
//     against x[:, K/2 + r]), each into its own f32 partial sum.
// Nibble to bf16: one prmt pairs byte j of rows 2t and 2t+1 (bits 0..7 and
// 16..23); a lop3 with 0x43004300 makes 128 + nibble, exact in bf16; one
// bf16x2 FMA (x 1 - 136) gives q, exact in -7..7.  So each product runs on
// the exact integer weights with f32 sums, and the scale multiplies a
// block's dot afterwards, as on the TPU (`fold`).
// C layout: c0, c1 are column 4g + j at batch rows 2t, 2t+1; c2, c3 column
// 32 + 4g + j at the same rows: one scale register each.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace int4mma {

constexpr int kTileRows = 64;                      // packed rows a tile
constexpr int kTileCols = 128;                     // columns (bytes) a tile
constexpr int kTileBytes = kTileRows * kTileCols;  // 8 KB
constexpr int kBatch = 8;                          // mma.sync's N
constexpr int kXTileBytes = kBatch * kTileRows * 2;  // x: 8 rows x 64 k bf16

// Byte offset of (row, col) in a 128-byte-swizzled tile.
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

__device__ __forceinline__ uint32_t ld_shared32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// q of both rows of a prmt pair: (128 + nibble) - 136, exact
__device__ __forceinline__ uint32_t unbias(uint32_t v) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

__device__ __forceinline__ uint32_t low_nibbles(uint32_t p) {
  return (p & 0x000F000Fu) | 0x43004300u;     // one lop3
}

__device__ __forceinline__ uint32_t high_nibbles(uint32_t p) {
  return ((p >> 4) & 0x000F000Fu) | 0x43004300u;
}

// Prefill: outT = W^T x^T on wgmma.m64nNk16 with A, 64 weight columns x 16
// k, from registers: warp w of the warpgroup holds A rows 16w..16w+15 in
// the m16n8k16 A layout.  The k index i of a k16 step is the step's packed
// row i (B, x's 16 k, comes from shared memory in the same order).  A's
// rows are permuted so that a warp reads one 16-byte chunk of each row:
// row 16w + g is the warpgroup's column 16w + 2g and row 16w + g + 8 the
// column after it, so the accumulator rows g and g + 8 of thread (g, t)
// are the output columns cb = c0 + 16w + 2g and cb + 1.  One
// ldmatrix.x4.trans of the bytes as b16 pairs (`ldsm_pairs`) gives lane
// (g, t) the pair of columns 2g, 2g + 1 of the chunk at rows 2t (bits
// 0..15) and 2t + 1 (16..31) of four 8-row groups: two k16 steps.  The
// 8 rows of a group are 8 chunks that the swizzle puts on distinct banks.

// Four 8 x 8 b16 matrices of the 128-byte-swizzled tile, transposed:
// lane l gives the address of row `row0 + l` (chunk `col` / 16) and gets
// d[j] = matrix j's (rows 2t, 2t + 1; b16 column g).
__device__ __forceinline__ void ldsm_pairs(uint32_t* d, const uint8_t* tile,
                                           int row0, int col) {
  const int lane = threadIdx.x & 31;
  const uint32_t addr = static_cast<uint32_t>(
      __cvta_generic_to_shared(tile + swz(row0 + lane, col)));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(addr)
      : "memory");
}

// The A fragment of one k16 step from its two `ldsm_pairs` words (rows
// 0..7 and 8..15 of the step): a0 (row g = column cb, k 2t, 2t+1) is byte 0
// and byte 2 of v0, a1 (row g + 8 = column cb + 1) bytes 1 and 3, a2, a3
// the same of v1.  `shift` 0 takes the low nibbles (the half k < K/2), 4
// the high ones.
__device__ __forceinline__ void wgmma_a(uint32_t* a, uint32_t v0,
                                        uint32_t v1, int shift) {
  a[0] = unbias(((v0 >> shift) & 0x000F000Fu) | 0x43004300u);
  a[1] = unbias(((v0 >> (shift + 8)) & 0x000F000Fu) | 0x43004300u);
  a[2] = unbias(((v1 >> shift) & 0x000F000Fu) | 0x43004300u);
  a[3] = unbias(((v1 >> (shift + 8)) & 0x000F000Fu) | 0x43004300u);
}

// One warp's k16 step over packed rows r0..r0+15 and the 64 columns
// c0..c0+63 (c0 a multiple of 64) of the tile at `tile`.  b_lo / b_hi: the
// B fragments of x at k = r and k = K/2 + r (rows of the step).  part_lo /
// part_hi[j]: n-tile j's f32 partial sums of the two halves.
__device__ __forceinline__ void step(const uint8_t* tile, int r0, int c0,
                                     const uint32_t* b_lo,
                                     const uint32_t* b_hi,
                                     float (*part_lo)[4],
                                     float (*part_hi)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // w[h][i]: columns c0 + 32 h + 4g..+3 of rows 2t, 2t+1, 2t+8, 2t+9
  uint32_t w[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 2 * t + (i & 1) + 8 * (i >> 1);
      w[h][i] = ld_shared32(tile + swz(row, c0 + 32 * h + 4 * g));
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte j of the first word into bits 0..7, of the second into 16..23
    const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
    // a0 rows (g, k 2t..), a1 (g + 8, k 2t..), a2 (g, k 2t + 8..), a3
    const uint32_t p[4] = {__byte_perm(w[0][0], w[0][1], sel),
                           __byte_perm(w[1][0], w[1][1], sel),
                           __byte_perm(w[0][2], w[0][3], sel),
                           __byte_perm(w[1][2], w[1][3], sel)};
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = unbias(low_nibbles(p[i]));
    flash::mma_bf16(part_lo[j], a, b_lo);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = unbias(high_nibbles(p[i]));
    flash::mma_bf16(part_hi[j], a, b_hi);
  }
}

// The B fragment of one k16 step from an x tile that TMA wrote with the
// 128-byte swizzle (8 batch rows x 64 k, bf16, 128 bytes a row): row g, k
// at k0 + 2t.., k0 + 2t + 8.. (k0 a multiple of 16).  Lanes g = 0..7 read
// chunks 2 k0 / 16 ^ g: 32 distinct banks.
__device__ __forceinline__ void load_b(uint32_t* b, const uint8_t* xtile,
                                       int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  b[0] = ld_shared32(xtile + swz(g, 2 * k0 + 4 * t));
  b[1] = ld_shared32(xtile + swz(g, 2 * k0 + 4 * t + 16));
}

// A scale block ends: acc += part x its column's scale, part = 0.  s0 holds
// the scales of columns c0 + 4g..+3 (n-tile j = component j), s1 those of
// c0 + 32 + 4g..+3.
__device__ __forceinline__ void fold(float (*acc)[4], float (*part)[4],
                                     float4 s0, float4 s1) {
  const float lo[4] = {s0.x, s0.y, s0.z, s0.w};
  const float hi[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[j][0] = fmaf(part[j][0], lo[j], acc[j][0]);
    acc[j][1] = fmaf(part[j][1], lo[j], acc[j][1]);
    acc[j][2] = fmaf(part[j][2], hi[j], acc[j][2]);
    acc[j][3] = fmaf(part[j][3], hi[j], acc[j][3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
  }
}

}  // namespace int4mma
