// Weight-only int8 GEMM for LLaMA decode and prefill on Hopper (sm_90a): a
// decode tile on mma.sync and a prefill tile on wgmma.
//
// Replaces the TPU kernel groma_tpu/ops/quant.py `_int8_matmul_kernel`
// (entry `int8_matmul`) and, from 256 rows on, the XLA route of the same
// entry.  The layout is the JAX package's: w (K, N) int8, N contiguous,
// symmetric q in [-127, 127], scale (N,) f32 per column.  No repacked copy
// of the weights exists.  The two routes round differently, as in JAX:
//
// * decode (M < 256): out = bf16(scale[n] * sum_k x[m, k] q[k, n]), the
//   scale after the dot (`int8_matmul_reference`).  Bound by the weight
//   bytes, K N, at 3.35 TB/s (the four 7B layer matmuls: 202 MB, 0.0605
//   ms); the products, 2 M K N, are a few us of mma.sync.  So the bytes
//   stream through an asynchronous ring and the tensor cores multiply:
//   - a CTA owns 128 columns, 8 rows of x (a grid dimension over 8-row
//     chunks; served decode is M = 1) and a range of K: split K in whole
//     128-row boxes, planned by the wrapper (ops/quant.py `decode_plan`)
//     to fill at most one wave of two CTAs per SM with equal ranges.  On an
//     H100 (132 SMs) at M <= 8: qkv 96 column tiles x 2 splits, o_proj
//     32 x 8, gate_up 172 x 1, down_proj 32 x 8, the lm head 252 x 1;
//   - one producer thread keeps TMA loads in flight through a 3-stage
//     mbarrier ring; a stage is the weight box (128 k rows x 128 columns,
//     16 KB, 128-byte swizzled, from a 2-d map of the (K, N) bytes, loaded
//     evict-first: each byte is read once) and x's two 8-row x 64-k boxes
//     (swizzled; rows past M and k past K read as zeros).  Nothing else in
//     the loop touches device memory;
//   - eight consumer warps: warp w runs k16 steps w % 4 and w % 4 + 4 of
//     every box on the 64-column group w / 4, outT = W^T x^T on
//     mma.sync.m16n8k16 bf16 -> f32, so the batch is N = 8 and M <= 8
//     pads nothing.  The fragment mapping is int4_mma.cuh's (`step`), with
//     one byte where int4 has two nibbles: one prmt pairs byte j of rows
//     2t and 2t + 1; the byte to bf16 splits it, (128 + its low 7 bits) -
//     (128 or 256 by its sign bit), two lop3 and one bf16x2 FMA, exact
//     (|q| <= 127 has 8 significant bits).  So the products are exact with
//     f32 sums, and the scale multiplies the finished dot;
//   - a warp releases a stage after fence.proxy.async: its ld.shared reads
//     are generic-proxy accesses and the refill is an async-proxy (TMA)
//     write, and without the fence a refill overtook the reads (wrong
//     outputs in up to 25 of 60 calls on an H100, none with it);
//   - the four k-slot warps of a column group are summed through shared
//     memory in a fixed order; with split K, every CTA writes its f32 sums
//     to a workspace, and the last CTA of a (column tile, row chunk) (an
//     arrival counter, which it resets to 0 for the next call) adds the
//     splits in split order, scales and writes bf16: one launch a call,
//     and two calls give bitwise-equal outputs;
//   - measured on an H100 while choosing this (development builds, not
//     kept; CUDA events, L2 flushed as chip_smoke times): 64-row boxes in
//     rings of 3 to 12 stages, 3, 4 or 6 CTAs per SM, split counts nearer
//     a full wave, 16 consumer warps, and the weight box loaded with
//     cp.async by the producer warp were all no faster or slower; 128-row
//     boxes beat 64 and 256, and the evict-first hint gained about 6 %.
//     With the L2 clean (not flushed) the tile's four layer matmuls take
//     about 7 % longer than the FMA kernel it replaces, all of it in
//     gate_up (172 CTAs, one split): dropping the consumers' math takes
//     gate_up from 0.046 to 0.037 ms, so their work is not hidden behind
//     the stream there, and a deeper ring does not hide it (PERF.md).
//
// * prefill (M >= 256): out = bf16(sum_k x[m, k] bf16(q[k, n] * scale[n])),
//   the weights dequantized to bf16 before a bf16 dot, bitwise the weights
//   `dequantize_weight` writes (`int8_matmul_dense_reference`), but never
//   written to memory.  Bound by the tensor cores, 2 M K N at 989 TFLOP/s
//   (the four layer matmuls at M = 2048: 0.838 ms; their bytes: 0.13 ms):
//   - outT = W^T x^T on wgmma.m64n256k16 bf16 -> f32: A (64 weight columns
//     x 16 k) from registers, B (16 k x 256 tokens) is x as TMA wrote it,
//     K-major (128-byte swizzle: a k16 step is +32 bytes, SBO 1024).  A's
//     rows are permuted as in int4_mma.cuh (`ldsm_pairs`): one
//     ldmatrix.x4.trans of the bytes as b16 pairs gives a thread columns
//     2g, 2g + 1 at k rows 2t, 2t + 1 of two k16 steps, so its A pairs are
//     bytes 0 and 2, and 1 and 3, of one register.  Each byte becomes f32
//     through the mantissa of 2^23 (prmt, exact fadd), is multiplied by its
//     column's f32 scale (__fmul_rn) and rounded to bf16 (cvt.rn.bf16x2):
//     dequantize_weight's arithmetic.  The 256 tokens of a tile share each
//     A fragment, halving the conversions a product of int4's 128-token
//     tile would need; int8 has no scale blocks, so the tile keeps one
//     accumulator set (128 registers a thread);
//   - a CTA owns 128 weight columns (two consumer warpgroups of 64) x 256
//     tokens and walks K in 64-row stages; each thread loads its two
//     columns' scales once per output tile;
//   - one producer thread keeps a 5-stage TMA ring in flight; a stage is
//     the weight box (64 rows x 128 columns, 8 KB, swizzled) and x's box
//     (256 tokens x 64 k, 32 KB).  Rows past M, k past K and columns past
//     N read as zeros and are never written.  206 KB of dynamic shared
//     memory: one CTA per SM;
//   - each warpgroup converts a stage's four A fragments, issues its four
//     products back to back and waits for them once; the other
//     warpgroup's products keep the tensor cores busy meanwhile.  Every A
//     fragment and accumulator is fenced before wgmma_fence, the mbarrier
//     wait precedes the products, and an A fragment is written only while
//     no product that reads it is in flight (ptxas serializes the products
//     or reuses their registers otherwise; PERF.md); the ldmatrix
//     reads are fenced (fence.proxy.async) before the stage is released;
//   - a persistent grid of one CTA per SM (the wrapper's `prefill_plan`)
//     walks the output tiles with the tokens fastest, so the CTAs in
//     flight share few column tiles: each weight tile comes from device
//     memory about once and x stays in L2.  No split K: two calls give
//     bitwise-equal outputs;
//   - epilogue: a thread's accumulator rows are two adjacent output
//     columns, so each of its 32-bit stores is one (token, column pair);
//   - setmaxnreg moves the producer warpgroup to 24 registers and the
//     consumers to 240.  The launch is refused (an error, not a hang) where
//     the shared memory or the registers cannot be had.
// Plain versions and wrapper: groma_tpu_torch/ops/quant.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int4_mma.cuh"
#include "sm90_common.cuh"

namespace {

using flash::bf16;
using int4mma::kTileBytes;
using int4mma::kTileCols;
using int4mma::kTileRows;

// ----------------------------------------------------------------- decode

using int4mma::kBatch;
using int4mma::kXTileBytes;
constexpr int kBoxTiles = 2;                   // 64-row tiles a box
constexpr int kBoxRows = kBoxTiles * kTileRows;   // k rows a stage
constexpr int kStages = 3;                     // depth of the ring
constexpr int kWarpSteps = 2;                  // k16 steps a warp, a box
constexpr int kKSlots = kBoxRows / 16 / kWarpSteps;   // warps a col group
constexpr int kConsumerWarps = 2 * kKSlots;    // two 64-column groups
constexpr int kDecodeThreads = 32 * (kConsumerWarps + 1);
constexpr int kOffX = kBoxTiles * kTileBytes;
constexpr int kStageBytes = kBoxTiles * (kTileBytes + kXTileBytes);  // 18 KB
static_assert(kStageBytes % 1024 == 0, "swizzled tiles are 1024-aligned");
static_assert(kConsumerWarps * kBatch * 64 * 4 <= kStages * kStageBytes,
              "the k-step sums reuse the ring");

// Dynamic shared memory: alignment slack, the ring, its barriers.
constexpr size_t kDecodeSmem = 1024 + (size_t)kStages * kStageBytes
                               + 2 * kStages * sizeof(uint64_t);

// Two int8 in bits 0..7 and 16..23 -> their exact bf16 pair: (128 + the
// low 7 bits) - (128, or 256 where the sign bit is set).
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t p) {
  const uint32_t low = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t sign = (p & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(sign), "r"(0xBF80BF80u), "r"(low));
  return d;
}

// One warp's k16 step over k rows r0..r0+15 and the 64 columns c0..c0+63
// of the tile at `tile` (int4_mma.cuh `step`'s fragment mapping): b holds
// the B fragment of x at those k, part[j] n-tile j's f32 sums.
__device__ __forceinline__ void step(const uint8_t* tile, int r0, int c0,
                                     const uint32_t* b, float (*part)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // w[h][i]: columns c0 + 32 h + 4g..+3 of rows 2t, 2t+1, 2t+8, 2t+9
  uint32_t w[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 2 * t + (i & 1) + 8 * (i >> 1);
      w[h][i] = int4mma::ld_shared32(tile
                                     + int4mma::swz(row, c0 + 32 * h + 4 * g));
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte j of the first word into bits 0..7, of the second into 16..23
    const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
    // a0 rows (g, k 2t..), a1 (g + 8, k 2t..), a2 (g, k 2t + 8..), a3
    const uint32_t a[4] = {
        bytes_to_bf16x2(__byte_perm(w[0][0], w[0][1], sel)),
        bytes_to_bf16x2(__byte_perm(w[1][0], w[1][1], sel)),
        bytes_to_bf16x2(__byte_perm(w[0][2], w[0][3], sel)),
        bytes_to_bf16x2(__byte_perm(w[1][2], w[1][3], sel))};
    flash::mma_bf16(part[j], a, b);
  }
}

__global__ void __launch_bounds__(kDecodeThreads, 2)
int8_decode_kernel(const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_x,
                   const float* __restrict__ scale,
                   void* __restrict__ out, int out_f32,
                   float* __restrict__ partial, int* __restrict__ counters,
                   int M, int K, int N, int split_rows) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  uint8_t* ring =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int col0 = blockIdx.x * kTileCols;
  const int split = blockIdx.y, splits = gridDim.y;
  const int m0 = blockIdx.z * kBatch;
  const int k_begin = split * split_rows;
  const int ntiles =
      (min(split_rows, K - k_begin) + kBoxRows - 1) / kBoxRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);   // lane 0 of each
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // --------------------------------------------------------- producer
    if (lane == 0) {
      sm90::prefetch_map(&tm_w);
      sm90::prefetch_map(&tm_x);
      const uint64_t evict_first = sm90::evict_first_policy();
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages, r = k_begin + i * kBoxRows;
        uint8_t* st = ring + s * kStageBytes;
        sm90::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);
        sm90::tma_load_2d_hint(st, &tm_w, &full[s], col0, r, evict_first);
        // rows of x past M, k past K and columns past N read as zeros
#pragma unroll
        for (int u = 0; u < kBoxTiles; ++u)
          sm90::tma_load_3d(st + kOffX + u * kXTileBytes, &tm_x, &full[s],
                            r + u * kTileRows, m0, 0);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp % kKSlots, grp = warp / kKSlots;   // k slot, columns
  float part[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages;
    const uint8_t* st = ring + s * kStageBytes;
    sm90::mbar_wait(&full[s], (i / kStages) & 1);
#pragma unroll
    for (int j = 0; j < kWarpSteps; ++j) {
      // k16 step q of the box: rows 16 q.., x's box q / 4
      const int q = kw + kKSlots * j;
      uint32_t b[2];
      int4mma::load_b(b, st + kOffX + (q / 4) * kXTileBytes, 16 * (q % 4));
      step(st, 16 * q, grp * 64, b, part);
    }
    // the stage's reads before its TMA refill
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  // the four k-step warps of a column group, summed in a fixed order
  // through the ring (every tile has been read): red[warp][m][64]; the C
  // fragment's rows are columns 4g + j and 32 + 4g + j, its columns the
  // rows 2t, 2t + 1 of x
  sm90::named_sync(1, 32 * kConsumerWarps);
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = 2 * t + (e & 1);
    *reinterpret_cast<float4*>(red + (warp * kBatch + m) * 64 + 32 * (e >> 1)
                               + 4 * g) =
        make_float4(part[0][e], part[1][e], part[2][e], part[3][e]);
  }
  sm90::named_sync(1, 32 * kConsumerWarps);
  for (int o = tid; o < kBatch * kTileCols; o += 32 * kConsumerWarps) {
    const int m = o / kTileCols, c = o % kTileCols;
    const int row = m0 + m, col = col0 + c;
    if (row >= M || col >= N) continue;
    const float* v = red + ((c / 64) * kKSlots * kBatch + m) * 64 + c % 64;
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < kKSlots; ++q) sum += v[q * kBatch * 64];
    if (splits == 1)
      sm90::store_out(out, (size_t)row * N + col, sum * scale[col],
                      out_f32);
    else
      partial[((size_t)split * M + row) * N + col] = sum;
  }
  if (splits == 1) return;

  // split K: the last CTA of the (column tile, row chunk) adds the splits
  // in order, then scales
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  __threadfence();
  sm90::named_sync(1, 32 * kConsumerWarps);
  if (tid == 0) s_last = atomicAdd(&counters[tile], 1) == splits - 1;
  sm90::named_sync(1, 32 * kConsumerWarps);
  if (!s_last) return;
  __threadfence();
  for (int o = tid; o < kBatch * kTileCols; o += 32 * kConsumerWarps) {
    const int row = m0 + o / kTileCols, col = col0 + o % kTileCols;
    if (row >= M || col >= N) continue;
    // unrolled, so that the loads of several splits are in flight at once
    float sum = 0.0f;
#pragma unroll 8
    for (int z = 0; z < splits; ++z)
      sum += __ldcg(partial + ((size_t)z * M + row) * N + col);
    sm90::store_out(out, (size_t)row * N + col, sum * scale[col],
                      out_f32);
  }
  if (tid == 0) counters[tile] = 0;           // ready for the next call
}

int launch_decode(const void* x, const void* w, const void* scale, void* out,
                  int out_f32, void* partial, void* counters, int M,
                  int K, int N, int split_rows, int splits,
                  cudaStream_t stream) {
  if (split_rows <= 0 || split_rows % kBoxRows || splits < 1
      || (long long)split_rows * splits < K
      || (long long)split_rows * (splits - 1) >= K
      || (splits > 1 && (partial == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDecodeSmem);
  if (err != cudaSuccess) return (int)err;     // the ring cannot be had
  if (sm90::encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tw, tx;
  if (!sm90::make_map_2d(&tw, w, 1, N, K, kTileCols, kBoxRows, true)
      || !sm90::make_map(&tx, x, K, M, 1, kBatch))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTileCols - 1) / kTileCols, splits,
                  (M + kBatch - 1) / kBatch);
  int8_decode_kernel<<<grid, kDecodeThreads, kDecodeSmem, stream>>>(
      tw, tx, static_cast<const float*>(scale), out, out_f32,
      static_cast<float*>(partial), static_cast<int*>(counters), M, K, N,
      split_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- prefill

constexpr int kPTok = 256;           // tokens a tile: wgmma's N
constexpr int kPCols = 128;          // weight columns a tile: two warpgroups
constexpr int kPRows = 64;           // k rows a stage
constexpr int kPStages = 5;          // depth of the ring
constexpr int kPConsumerWarps = 8;   // two warpgroups of 64 columns
constexpr int kPThreads = 32 * kPConsumerWarps + 128;   // + the producer's
// setmaxnreg moves the producer warpgroup's registers to the consumers
constexpr int kPProducerRegs = 24;
constexpr int kPConsumerRegs =
    (((65536 / kPThreads) & ~7) * kPThreads - 128 * kPProducerRegs)
    / (32 * kPConsumerWarps) & ~7;                        // 240
static_assert(kPConsumerRegs <= 256, "setmaxnreg takes at most 256");
constexpr int kPAcc = kPTok / 2;               // f32 accumulators a thread
// a stage: the weight box (64 rows x 128 columns), then x's box (256
// tokens x 64 k bf16)
constexpr int kPOffX = kPRows * kPCols;
constexpr int kPStageBytes = kPOffX + kPTok * kPRows * 2;      // 40 KB
static_assert(kPStageBytes % 1024 == 0, "swizzled tiles are 1024-aligned");
constexpr size_t kPrefillSmem = 1024 + (size_t)kPStages * kPStageBytes
                                + 2 * kPStages * sizeof(uint64_t);

// Bytes b and b + 2 of u (each q + 128) -> bf16x2 of bf16_rn(f32(q) * s):
// 2^23 + q + 128 in f32 by a byte permute, less 2^23 + 128 (exact), times
// the column's scale, rounded to f32 and then to bf16, as
// `dequantize_weight` rounds.
__device__ __forceinline__ uint32_t dequant_pair(uint32_t u, int b,
                                                 float s) {
  const float lo =
      __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + b)) - 8388736.0f;
  const float hi =
      __int_as_float(__byte_perm(u, 0x4B000000u, 0x7442 + b)) - 8388736.0f;
  return sm90::pack_bf16(__fmul_rn(lo, s), __fmul_rn(hi, s));
}

// The A fragment of one k16 step from its two `ldsm_pairs` words (k rows
// 0..7 and 8..15 of the step): a0 (row g = column cb, k 2t, 2t+1) is bytes
// 0 and 2 of v0, a1 (row g + 8 = column cb + 1) bytes 1 and 3, a2, a3 the
// same of v1; s0, s1 the scales of columns cb and cb + 1.
__device__ __forceinline__ void wgmma_a(uint32_t* a, uint32_t v0,
                                        uint32_t v1, float s0, float s1) {
  const uint32_t u0 = v0 ^ 0x80808080u, u1 = v1 ^ 0x80808080u;
  a[0] = dequant_pair(u0, 0, s0);
  a[1] = dequant_pair(u0, 1, s1);
  a[2] = dequant_pair(u1, 0, s0);
  a[3] = dequant_pair(u1, 1, s1);
}

__global__ void __launch_bounds__(kPThreads, 1)
int8_prefill_kernel(const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_x,
                    const float* __restrict__ scale,
                   void* __restrict__ out, int out_f32,
                    int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kPStages * kPStageBytes);
  uint64_t* empty = full + kPStages;

  const int ksteps = (K + kPRows - 1) / kPRows;
  const int tok_tiles = (M + kPTok - 1) / kPTok;
  const int tiles = tok_tiles * ((N + kPCols - 1) / kPCols);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kPStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kPConsumerWarps);   // lane 0 of each
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // tile -> (column tile tile / tok_tiles, token tile tile % tok_tiles):
  // the CTAs in flight share few column tiles, so each weight tile comes
  // from device memory about once and x stays in L2
  if (warp >= kPConsumerWarps) {
    // --------------------------------------------------------- producer
    sm90::setmaxnreg_dec<kPProducerRegs>();
    if (warp == kPConsumerWarps && lane == 0) {
      sm90::prefetch_map(&tm_w);
      sm90::prefetch_map(&tm_x);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int col0 = tile / tok_tiles * kPCols;
        const int tok0 = tile % tok_tiles * kPTok;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int s = it % kPStages, k0 = ks * kPRows;
          uint8_t* st = ring + s * kPStageBytes;
          sm90::mbar_wait(&empty[s], ((it / kPStages) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&full[s], kPStageBytes);
          sm90::tma_load_2d(st, &tm_w, &full[s], col0, k0);
          // rows of x past M, k past K and columns past N read as zeros
          sm90::tma_load_3d(st + kPOffX, &tm_x, &full[s], k0, tok0, 0);
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  sm90::setmaxnreg_inc<kPConsumerRegs>();
  // warpgroup wg owns columns 64 wg.. of the tile; this thread's
  // accumulator rows are the columns cb and cb + 1 (int4_mma.cuh
  // `ldsm_pairs`), element 4j + e at column cb + (e >> 1), token
  // 8j + 2t + (e & 1)
  const int g = lane >> 2, t = lane & 3;
  const int c16 = 64 * (warp >> 2) + 16 * (warp & 3);   // the warp's chunk
  const int cb = c16 + 2 * g;
  float acc[kPAcc];
#pragma unroll
  for (int i = 0; i < kPAcc; ++i) acc[i] = 0.0f;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int col0 = tile / tok_tiles * kPCols;
    const int tok0 = tile % tok_tiles * kPTok;
    const int col = col0 + cb;                 // N is even: col + 1 < N too
    const float s0 = col < N ? __ldg(scale + col) : 0.0f;
    const float s1 = col < N ? __ldg(scale + col + 1) : 0.0f;
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      const int s = it % kPStages;
      const uint8_t* st = ring + s * kPStageBytes;
      const uint32_t sx = sm90::smem_u32(st + kPOffX);
      // the wait before the products: a spin loop between two of them
      // would make ptxas serialize them
      sm90::mbar_wait(&full[s], (it / kPStages) & 1);
      // the stage's A fragments, then its products back to back; the
      // other warpgroup's products run while this one converts
      uint32_t v[kPRows / 32][4], a[kPRows / 16][4];
#pragma unroll
      for (int q = 0; q < kPRows / 32; ++q)
        int4mma::ldsm_pairs(v[q], st, 32 * q, c16);
#pragma unroll
      for (int kk = 0; kk < kPRows / 16; ++kk)
        wgmma_a(a[kk], v[kk / 2][2 * (kk & 1)], v[kk / 2][2 * (kk & 1) + 1],
                s0, s1);
      sm90::fence_regs<kPRows / 4>(&a[0][0]);
      sm90::fence_regs<kPAcc>(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPRows / 16; ++kk)
        sm90::wgmma_rs_n256<0>(acc, a[kk], sm90::desc(sx + kk * 32, 16, 1024),
                               ks > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<kPAcc>(acc);
      // the ldmatrix reads before the stage's TMA refill
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
    // out rows tok, tok + 1, columns col, col + 1: 32-bit stores, a warp's
    // 8 lanes of one t filling a 32-byte sector
    if (col < N) {
#pragma unroll
      for (int j = 0; j < kPTok / 8; ++j) {
        const int tok = tok0 + 8 * j + 2 * t;
        if (tok < M)
          sm90::store_out2(out, (size_t)tok * N + col, acc[4 * j],
                           acc[4 * j + 2], out_f32);
        if (tok + 1 < M)
          sm90::store_out2(out, (size_t)(tok + 1) * N + col, acc[4 * j + 1],
                           acc[4 * j + 3], out_f32);
      }
    }
  }
}

int launch_prefill(const void* x, const void* w, const void* scale,
                   void* out, int out_f32, int M, int K, int N, int ctas,
                   cudaStream_t stream) {
  if (ctas < 1) return (int)cudaErrorInvalidValue;
  // setmaxnreg moves registers within the CTA's launch allocation: refuse
  // to launch (rather than hang) if it is too small
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, int8_prefill_kernel);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs * kPThreads
      < 128 * kPProducerRegs + 32 * kPConsumerWarps * kPConsumerRegs)
    return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(
      int8_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kPrefillSmem);
  if (err != cudaSuccess) return (int)err;     // the ring cannot be had
  if (sm90::encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tw, tx;
  if (!sm90::make_map_2d(&tw, w, 1, N, K, kPCols, kPRows, true)
      || !sm90::make_map(&tx, x, K, M, 1, kPTok))
    return (int)cudaErrorInvalidValue;
  int8_prefill_kernel<<<ctas, kPThreads, kPrefillSmem, stream>>>(
      tw, tx, static_cast<const float*>(scale), out, out_f32, M,
      K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, w (K, N) int8, scale (N,) f32, out (M, N) bf16 (f32
// where out_f32 is nonzero: the values the bf16 store rounds), all
// contiguous, x and w 16-byte aligned, K a multiple of 8 and N of 16 (the
// tensor maps' row pitches).  split_rows = 0 runs the prefill tile on a
// persistent grid of `splits` CTAs; else the decode tile over `splits`
// ranges of split_rows k rows (a multiple of 128) that cover K, the last one
// not empty, for every 8-row chunk of x.  With split_rows > 0 and
// splits > 1, `partial` is an f32 (splits, M, N) workspace and `counters`
// one int per (128-column tile, 8-row chunk), zero before the call and
// zero again after it.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int groma_int8_matmul(const void* x, const void* w,
                                 const void* scale, void* out, void* partial,
                                 void* counters, int M, int K, int N,
                                 int split_rows, int splits, int out_f32,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 8 || K % 8 || N < 16 || N % 16)
    return (int)cudaErrorInvalidValue;
  if (split_rows > 0)
    return launch_decode(x, w, scale, out, out_f32, partial, counters, M,
                         K, N, split_rows, splits, s);
  return launch_prefill(x, w, scale, out, out_f32, M, K, N, splits, s);
}
