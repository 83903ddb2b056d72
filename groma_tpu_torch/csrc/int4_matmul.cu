// Weight-only packed-int4 GEMM for LLaMA decode and prefill on Hopper
// (sm_90a).
//
// Replaces the TPU kernel groma_tpu/ops/quant4.py `_int4_matmul_kernel`
// (entry `int4_matmul`).  Computes out (M, N) bf16 =
//   sum_b scale[b, n] * sum_{k in block b} x[m, k] * (nibble(k, n) - 8)
// with f32 sums: each 256-row block's dot runs on the exact integer weights
// and its scale multiplies the dot afterwards, as on the TPU.  The byte
// layout is the JAX package's: packed (K/2, N) uint8, row k in the low
// nibble of byte (k, n) and row k + K/2 in its high nibble, each stored as
// q + 8; scale (K/256, N) f32.  K must be a multiple of 256 (so K/2 is one
// of 128) and N of 64.  No repacked copy of the weights exists.
//
// Two tiles in one source, as the TPU kernel computes the product in its
// own body at every M:
//
// * decode (M <= 8): bound by the weight bytes, K N / 2 + the scales'
//   K N / 64, at 3.35 TB/s (qkv_proj 0.0078 ms, the four layer matmuls
//   0.0315 ms, the lm head 0.0205 ms); the products, 2 M K N, are a few us
//   of mma.sync.  So the bytes stream through an asynchronous ring and the
//   tensor cores do the multiplies:
//   - a CTA owns 128 columns and a range of packed rows: split K in whole
//     64-row tiles, planned by the wrapper (ops/quant4.py `decode_plan`) to
//     fill at most one wave of two CTAs per SM with equal ranges.  On an
//     H100 (132 SMs): qkv 96 column tiles x 2 splits, o_proj 32 x 8,
//     gate_up 172 x 1, down_proj 32 x 8, the lm head 252 x 1;
//   - one producer thread keeps TMA loads in flight through a kStages-deep
//     mbarrier ring; a stage is the weight box (64 packed rows x 128
//     columns, 8 KB, 128-byte swizzled, from a 2-d map of the (K/2, N)
//     bytes), x's two 8-row x 64-k boxes at k = r and K/2 + r (swizzled;
//     rows past M read as zeros) and, where a scale block of either half
//     ends, its scale row (128 f32).  Columns past N (N % 128 = 64) read as
//     zeros and are never written.  4 stages of 11 KB: 44 KB in flight per
//     CTA, 88 KB per SM.  Nothing else in the loop touches device memory;
//   - eight consumer warps: warp w runs k16 step w % 4 of every tile on the
//     64-column group w / 4, with the batch as mma.sync's N (the fragment
//     mapping, the unpack and the scale fold are int4_mma.cuh's);
//   - a 64-row tile lies in one scale block of each half (K/2 is a multiple
//     of 128, so the high half's blocks start at packed rows = -K/2 mod
//     256, 0 or 128): down_proj's block 21, straddling K/2 = 5504, needs no
//     special case.  Each half keeps its own partial sums, folded with the
//     block's scale when its block ends, 128 packed rows out of phase with
//     the other half's for down_proj;
//   - the four k-step warps of a column group are summed through shared
//     memory in a fixed order; with split K, every CTA writes its f32 sums
//     to a workspace, and the last CTA of a column tile (a per-tile arrival
//     counter, which it resets to 0 for the next call) adds the splits in
//     split order and writes bf16: one launch a call, and two calls give
//     bitwise-equal outputs;
//   - budget (ptxas -v on sm_90a): 92 registers, no spills; 45 KB of
//     dynamic shared memory (1 KB alignment, the ring, its barriers): two
//     288-thread CTAs per SM, held by the registers.  The launch is refused
//     (an error, not a hang) where the shared memory cannot be had.
//   Measured on an H100 while choosing this (development builds, not kept):
//   rings of 4 to 10 stages run in the same time, and a per-tile trace
//   shows each box's load taking several times the consumers' work on it:
//   device memory, not the ring or the tensor cores, sets the pace.
//   Three CTAs per SM (72 registers, spills), 256-column CTAs of 16
//   consumer warps, and a split-K sum over a thread-block cluster's
//   distributed shared memory in place of the workspace were all slower;
//   scales read with plain loads at each block's end stalled the warps.
//
// * prefill (M > 8): tensor cores, mma.sync m16n8k16 bf16 with f32
//   accumulators (flash_common.cuh).  A 256-thread block owns a 128 x 64
//   output tile (8 warps of 32 x 32) and walks K in 64-row tiles; each tile
//   lies in one half and one scale block.  x is staged into shared memory
//   as it is; the weight tile's nibbles are unpacked to bf16 (q, exact in
//   -7..7) and stored transposed, so the B fragments are 32-bit loads.  The
//   products of one scale block accumulate in a second set of f32
//   registers, which is scaled per column and added at the block's end:
//   the dot runs on the exact integer weights and the scale is applied
//   after it, as on the TPU.  The next tile's global loads are issued into
//   registers before the current tile's products.
// Plain version and wrapper: groma_tpu_torch/ops/quant4.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "int4_mma.cuh"
#include "sm90_common.cuh"

namespace {

using flash::bf16;
using int4mma::kTileBytes;
using int4mma::kTileCols;
using int4mma::kTileRows;

constexpr int kScaleBlock = 256;   // K rows per scale row
constexpr int kThreads = 256;      // the prefill tile's block

// ----------------------------------------------------------------- decode

using int4mma::kBatch;
using int4mma::kXTileBytes;
constexpr int kStages = 4;                     // depth of the ring
constexpr int kConsumerWarps = 8;              // 4 k16 steps x 2 col groups
constexpr int kDecodeThreads = 32 * (kConsumerWarps + 1);
// a stage: the weight tile, x's tiles at k = r and K/2 + r, and the scale
// rows of the tile's low and high blocks (loaded where a block ends)
constexpr int kScaleRowBytes = kTileCols * 4;
constexpr int kOffX = kTileBytes;
constexpr int kOffScale = kOffX + 2 * kXTileBytes;
constexpr int kStageBytes = kOffScale + 2 * kScaleRowBytes;   // 11 KB
static_assert(kStageBytes % 1024 == 0, "swizzled tiles are 1024-aligned");

// Dynamic shared memory: alignment slack, the ring, its barriers.
constexpr size_t kDecodeSmem = 1024 + (size_t)kStages * kStageBytes
                               + 2 * kStages * sizeof(uint64_t);

__global__ void __launch_bounds__(kDecodeThreads, 2)
int4_decode_kernel(const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_s,
                   bf16* __restrict__ out,
                   float* __restrict__ partial, int* __restrict__ counters,
                   int M, int K, int N, int split_rows) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  uint8_t* ring =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int kh = K / 2;
  const int col0 = blockIdx.x * kTileCols;
  const int split = blockIdx.y, splits = gridDim.y;
  const int p_begin = split * split_rows;
  const int ntiles = min(split_rows, kh - p_begin) / kTileRows;
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
      sm90::prefetch_map(&tm_s);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages, r = p_begin + i * kTileRows;
        const bool last = i + 1 == ntiles;
        const bool fold_lo = last || (r + kTileRows) % kScaleBlock == 0;
        const bool fold_hi = last || (r + kTileRows + kh) % kScaleBlock == 0;
        uint8_t* st = ring + s * kStageBytes;
        sm90::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(
            &full[s], kOffScale + (fold_lo + fold_hi) * kScaleRowBytes);
        sm90::tma_load_2d(st, &tm_w, &full[s], col0, r);
        // rows of x past M and columns past N read as zeros
        sm90::tma_load_3d(st + kOffX, &tm_x, &full[s], r, 0, 0);
        sm90::tma_load_3d(st + kOffX + kXTileBytes, &tm_x, &full[s], kh + r,
                          0, 0);
        if (fold_lo)
          sm90::tma_load_2d(st + kOffScale, &tm_s, &full[s], col0,
                            r / kScaleBlock);
        if (fold_hi)
          sm90::tma_load_2d(st + kOffScale + kScaleRowBytes, &tm_s, &full[s],
                            col0, (r + kh) / kScaleBlock);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  const int g = lane >> 2, t = lane & 3;
  const int ks = warp & 3, grp = warp >> 2;      // k16 step, column group
  const int c0 = grp * 64;
  float acc[4][4], part_lo[4][4], part_hi[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = part_lo[j][e] = part_hi[j][e] = 0.0f;

  for (int i = 0; i < ntiles; ++i) {
    const int r = p_begin + i * kTileRows;       // the tile's packed row
    const bool last = i + 1 == ntiles;
    const bool fold_lo = last || (r + kTileRows) % kScaleBlock == 0;
    const bool fold_hi = last || (r + kTileRows + kh) % kScaleBlock == 0;
    const int s = i % kStages;
    const uint8_t* st = ring + s * kStageBytes;
    sm90::mbar_wait(&full[s], (i / kStages) & 1);
    uint32_t b_lo[2], b_hi[2];
    int4mma::load_b(b_lo, st + kOffX, 16 * ks);
    int4mma::load_b(b_hi, st + kOffX + kXTileBytes, 16 * ks);
    int4mma::step(st, 16 * ks, c0, b_lo, b_hi, part_lo, part_hi);
    // scales of columns col0 + c0 + 4g..+3 and + 32 (zeros past N)
    const float* sc = reinterpret_cast<const float*>(st + kOffScale) + c0
                      + 4 * g;
    if (fold_lo)
      int4mma::fold(acc, part_lo, *reinterpret_cast<const float4*>(sc),
                    *reinterpret_cast<const float4*>(sc + 32));
    if (fold_hi)
      int4mma::fold(acc, part_hi,
                    *reinterpret_cast<const float4*>(sc + kTileCols),
                    *reinterpret_cast<const float4*>(sc + kTileCols + 32));
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  // the four k-step warps of a column group, summed in a fixed order
  // through the ring (every tile has been read): red[warp][m][64]
  sm90::named_sync(1, 32 * kConsumerWarps);
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = 2 * t + (e & 1);
    *reinterpret_cast<float4*>(red + (warp * kBatch + m) * 64 + 32 * (e >> 1)
                               + 4 * g) =
        make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
  }
  sm90::named_sync(1, 32 * kConsumerWarps);
  for (int o = tid; o < kBatch * kTileCols; o += 32 * kConsumerWarps) {
    const int m = o / kTileCols, c = o % kTileCols;
    const int col = col0 + c;
    if (m >= M || col >= N) continue;
    const float* v = red + ((c / 64) * 4 * kBatch + m) * 64 + c % 64;
    const float sum = ((v[0] + v[kBatch * 64]) + v[2 * kBatch * 64])
                      + v[3 * kBatch * 64];
    if (splits == 1)
      out[(size_t)m * N + col] = __float2bfloat16(sum);
    else
      partial[((size_t)split * M + m) * N + col] = sum;
  }
  if (splits == 1) return;

  // split K: the last CTA of the column tile adds the splits in order
  __threadfence();
  sm90::named_sync(1, 32 * kConsumerWarps);
  if (tid == 0)
    s_last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  sm90::named_sync(1, 32 * kConsumerWarps);
  if (!s_last) return;
  __threadfence();
  for (int o = tid; o < kBatch * kTileCols; o += 32 * kConsumerWarps) {
    const int m = o / kTileCols, col = col0 + o % kTileCols;
    if (m >= M || col >= N) continue;
    // unrolled, so that the loads of several splits are in flight at once
    float sum = 0.0f;
#pragma unroll 8
    for (int z = 0; z < splits; ++z)
      sum += __ldcg(partial + ((size_t)z * M + m) * N + col);
    out[(size_t)m * N + col] = __float2bfloat16(sum);
  }
  if (tid == 0) counters[blockIdx.x] = 0;     // ready for the next call
}

int launch_decode(const void* x, const void* w, const void* scale, void* out,
                  void* partial, void* counters, int M, int K, int N,
                  int split_rows, int splits, cudaStream_t stream) {
  const int kh = K / 2;
  if (M > kBatch || split_rows <= 0 || split_rows % kTileRows || splits < 1
      || (long long)split_rows * splits < kh
      || (long long)split_rows * (splits - 1) >= kh
      || (splits > 1 && (partial == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int4_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDecodeSmem);
  if (err != cudaSuccess) return (int)err;     // the ring cannot be had
  if (sm90::encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tw, tx, ts;
  if (!sm90::make_map_2d(&tw, w, 1, N, kh, kTileCols, kTileRows, true)
      || !sm90::make_map(&tx, x, K, M, 1, kBatch)
      || !sm90::make_map_2d(&ts, scale, 4, N, K / kScaleBlock, kTileCols, 1,
                            false))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTileCols - 1) / kTileCols, splits);
  int4_decode_kernel<<<grid, kDecodeThreads, kDecodeSmem, stream>>>(
      tw, tx, ts, static_cast<bf16*>(out),
      static_cast<float*>(partial), static_cast<int*>(counters), M, K, N,
      split_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- prefill

constexpr int kBM = 128;             // output rows a block
constexpr int kBN = 64;              // output columns a block
constexpr int kBK = 64;              // K rows a tile
constexpr int kPitch = kBK + 8;      // 36 words: fragment loads hit 32 banks

struct PrefillRegs {
  uint4 x[kBM * kBK / 8 / kThreads];   // 4 x 16 bytes of x
  uint2 w[2];                          // 8 bytes of two packed rows
};

__device__ __forceinline__ void prefill_load(PrefillRegs& rg,
                                             const bf16* __restrict__ x,
                                             const uint8_t* __restrict__ w,
                                             int m0, int n0, int k0, int M,
                                             int K, int N, int tid) {
  const int kh = K / 2;
  const int p0 = k0 < kh ? k0 : k0 - kh;
#pragma unroll
  for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
    rg.x[i] = m0 + r < M
                  ? __ldg(reinterpret_cast<const uint4*>(
                        x + (size_t)(m0 + r) * K + k0 + c))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  // thread -> (row pair tid % 32, 8-column group tid / 32)
  const int rp = tid & 31, cgrp = tid >> 5;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    rg.w[j] = __ldg(reinterpret_cast<const uint2*>(
        w + (size_t)(p0 + 2 * rp + j) * N + n0 + cgrp * 8));
}

__device__ __forceinline__ void prefill_store(const PrefillRegs& rg,
                                              bf16* As, bf16* Bs, bool high,
                                              int tid) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
    *reinterpret_cast<uint4*>(As + r * kPitch + c) = rg.x[i];
  }
  const int rp = tid & 31, cgrp = tid >> 5;
  const int shift = high ? 4 : 0;
  const uint32_t r0[2] = {rg.w[0].x, rg.w[0].y};
  const uint32_t r1[2] = {rg.w[1].x, rg.w[1].y};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q0 = (int)((r0[j >> 2] >> (8 * (j & 3) + shift)) & 0xFu) - 8;
    const int q1 = (int)((r1[j >> 2] >> (8 * (j & 3) + shift)) & 0xFu) - 8;
    // Bs[n][k]: column n of the tile holds its k rows 2 rp, 2 rp + 1
    *reinterpret_cast<uint32_t*>(Bs + (cgrp * 8 + j) * kPitch + 2 * rp) =
        flash::pack((float)q0, (float)q1);
  }
}

__global__ void __launch_bounds__(kThreads)
int4_prefill_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                    const float* __restrict__ scale, bf16* __restrict__ out,
                    int M, int K, int N) {
  __shared__ __align__(16) bf16 As[kBM * kPitch];
  __shared__ __align__(16) bf16 Bs[kBN * kPitch];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;           // 4 x 2 warps
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kh = K / 2;
  const int ktiles = K / kBK;

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = part[mi][ni][e] = 0.0f;

  PrefillRegs rg;
  prefill_load(rg, x, w, m0, n0, 0, M, K, N, tid);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                 // the previous tile's fragments are read
    prefill_store(rg, As, Bs, k0 >= kh, tid);
    __syncthreads();
    if (kt + 1 < ktiles)
      prefill_load(rg, x, w, m0, n0, k0 + kBK, M, K, N, tid);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        flash::load_a(a[mi], As, kPitch, wm * 32 + mi * 16 + g,
                      kk * 16 + 2 * t);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        flash::load_b(b[ni], Bs, kPitch, wn * 32 + ni * 8 + g,
                      kk * 16 + 2 * t);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) flash::mma_bf16(part[mi][ni], a[mi], b[ni]);
    }
    const int blk = k0 / kScaleBlock;
    if (kt + 1 == ktiles || (k0 + kBK) / kScaleBlock != blk) {
      // the scale block ends: scale its products per column, add, reset
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        const float2 s = __ldg(reinterpret_cast<const float2*>(
            scale + (size_t)blk * N + col));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          acc[mi][ni][0] = fmaf(part[mi][ni][0], s.x, acc[mi][ni][0]);
          acc[mi][ni][1] = fmaf(part[mi][ni][1], s.y, acc[mi][ni][1]);
          acc[mi][ni][2] = fmaf(part[mi][ni][2], s.x, acc[mi][ni][2]);
          acc[mi][ni][3] = fmaf(part[mi][ni][3], s.y, acc[mi][ni][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.0f;
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm * 32 + mi * 16 + g;
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

}  // namespace

// x (M, K) bf16, w (K/2, N) uint8, scale (K/256, N) f32, out (M, N) bf16,
// all contiguous, x, w and scale 16-byte aligned.  split_rows = 0 runs the
// prefill tile (any M); else the decode tile (M <= 8) over `splits` ranges
// of split_rows packed rows (a multiple of 64, at most 1024) that cover K/2,
// the last one not empty.  With splits > 1, `partial` is an f32 (splits, M,
// N) workspace and `counters` one int per 128-column tile, zero before the
// call and zero again after it.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int groma_int4_matmul(const void* x, const void* w,
                                 const void* scale, void* out, void* partial,
                                 void* counters, int M, int K, int N,
                                 int split_rows, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < kScaleBlock || K % kScaleBlock || N < kBN || N % kBN)
    return (int)cudaErrorInvalidValue;
  if (split_rows > 0)
    return launch_decode(x, w, scale, out, partial, counters, M, K, N,
                         split_rows, splits, s);
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  int4_prefill_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<bf16*>(out), M, K, N);
  return (int)cudaGetLastError();
}
