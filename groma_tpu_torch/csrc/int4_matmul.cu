// Weight-only packed-int4 GEMM for LLaMA decode and prefill on Hopper
// (sm_90a): a decode tile on mma.sync and a prefill tile on wgmma.
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
// * prefill (M > 8): bound by the tensor cores, 2 M K N operations at
//   989 TFLOP/s bf16 (the four layer matmuls at M = 2048: 0.838 ms; the
//   bytes they must move: 0.11 ms).  A wgmma product with the weights
//   unpacked in registers:
//   - the operands are swapped, outT = W^T x^T, on wgmma.m64n128k16 bf16 ->
//     f32: A (64 weight columns x 16 k) from registers, B (16 k x 128
//     tokens) is x as TMA wrote it, K-major (k contiguous, 128-byte
//     swizzle: a k16 step is +32 bytes, SBO 1024), wgmma's plain case.  A's
//     rows are permuted so that a warp's bytes are one 16-byte chunk of a
//     packed row: ldmatrix.x4.trans of the packed bytes as b16 pairs gives
//     each thread two columns at two k rows in one register, and the
//     nibble to bf16 is a shift, a lop3 and a bf16x2 FMA (exact, as for
//     decode; int4_mma.cuh `ldsm_pairs`, `wgmma_a`).  So no unpacked weight
//     touches shared memory and one A fragment serves 128 tokens;
//   - a CTA owns 128 weight columns (two consumer warpgroups of 64) x 128
//     tokens and walks K in stages of 128 rows: the low half (low nibbles of
//     packed rows k, against x[:, k]) and then the high half (high nibbles,
//     against x[:, K/2 + k]), each stage inside one half and one scale
//     block.  A stage's block dot accumulates in one f32 set (64 registers
//     a thread) and is folded into the output set with the block's scale
//     (one register per accumulator row: a column) where the block or the
//     half ends; down_proj's block 21, straddling K/2 = 5504, folds at K/2
//     and at its end.  Sweeping the halves one after the other reads each
//     packed byte twice (from L2) but keeps two accumulator sets, not three;
//   - one producer thread keeps a 4-stage TMA ring in flight through
//     mbarriers; a stage is the packed box (128 rows x 128 columns, 16 KB,
//     swizzled), x's two 128-token x 64-k boxes (32 KB) and, where a block
//     ends, its scale row.  Rows past M and columns past N read as zeros and
//     are never written.  197 KB of dynamic shared memory: one CTA per SM;
//   - each warpgroup unpacks a stage's eight A fragments, then issues its
//     eight products back to back and waits for them once; the other
//     warpgroup's products keep the tensor cores busy meanwhile.  Every A
//     fragment and accumulator is fenced before wgmma_fence, and the
//     mbarrier wait precedes the products (ptxas serializes them otherwise);
//   - a persistent grid of one CTA per SM (the wrapper's `prefill_plan`)
//     walks the output tiles with the tokens fastest, so the CTAs in
//     flight share few column tiles: each packed tile comes from device
//     memory about once and x stays in L2.  No split K: every output is
//     written by one CTA, and two calls give bitwise-equal outputs;
//   - epilogue: a thread's accumulator rows are two adjacent output
//     columns, so each of its 32-bit stores is one (token, column pair) and
//     the 8 lanes that share t fill a 32-byte sector: no staging through
//     shared memory;
//   - budget (ptxas -v on sm_90a): 168 registers a thread at launch (384
//     threads), setmaxnreg moves the producer warpgroup to 24 and the
//     consumers to 240; no spills, no serialized wgmma.  The launch is
//     refused (an error, not a hang) where the shared memory or the
//     registers cannot be had.
//   Measured on an H100 while choosing this (development builds, not kept):
//   unpacking with four 16-bit loads a k16 step, interleaved with the
//   products, took about 1.25 times the present time; 64-row stages, a
//   3-stage ring and explicit ping-pong ordering of the two warpgroups were
//   no faster; unpacking the next stage under the current stage's products
//   was slower and gave wrong outputs: its SASS shows ptxas writing the new
//   fragments into the registers that the in-flight products read (an
//   empty asm fence emits no PTX), so a fragment is written only while no
//   product that reads it runs; dropping the x or the weight loads did not
//   change the time of the first version (the consumers' instruction
//   stream, not L2, set the pace).
// Plain version and wrapper: groma_tpu_torch/ops/quant4.py.

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

constexpr int kScaleBlock = 256;   // K rows per scale row

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
                   void* __restrict__ out, int out_f32,
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
    // the stage's reads before its TMA refill
    sm90::fence_proxy_async();
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
      sm90::store_out(out, (size_t)m * N + col, sum, out_f32);
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
    sm90::store_out(out, (size_t)m * N + col, sum, out_f32);
  }
  if (tid == 0) counters[blockIdx.x] = 0;     // ready for the next call
}

int launch_decode(const void* x, const void* w, const void* scale, void* out,
                  int out_f32, void* partial, void* counters, int M,
                  int K, int N, int split_rows, int splits,
                  cudaStream_t stream) {
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
      tw, tx, ts, out, out_f32,
      static_cast<float*>(partial), static_cast<int*>(counters), M, K, N,
      split_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- prefill

constexpr int kPTok = 128;           // tokens a tile: wgmma's N
constexpr int kPCols = 128;          // weight columns a tile: two warpgroups
constexpr int kPRows = 128;          // k rows a stage (packed rows of a half)
constexpr int kPStages = 4;          // depth of the ring
constexpr int kPConsumerWarps = 8;   // two warpgroups of 64 columns
constexpr int kPThreads = 32 * kPConsumerWarps + 128;   // + the producer's
// setmaxnreg moves the producer warpgroup's registers to the consumers
constexpr int kPProducerRegs = 24;
constexpr int kPConsumerRegs =
    (((65536 / kPThreads) & ~7) * kPThreads - 128 * kPProducerRegs)
    / (32 * kPConsumerWarps) & ~7;                        // 240
static_assert(kPConsumerRegs <= 256, "setmaxnreg takes at most 256");
constexpr int kPBoxBytes = kPTok * 64 * 2;     // x: 128 tokens x 64 k bf16
// a stage: the packed box (128 rows x 128 columns), x's two 64-k boxes
// and, where a scale block ends, its scale row
constexpr int kPOffX = kPRows * kPCols;
constexpr int kPOffScale = kPOffX + (kPRows / 64) * kPBoxBytes;
constexpr int kPStageBytes = kPOffScale + 1024;                 // 49 KB
static_assert(kPStageBytes % 1024 == 0, "swizzled tiles are 1024-aligned");
constexpr size_t kPrefillSmem = 1024 + (size_t)kPStages * kPStageBytes
                                + 2 * kPStages * sizeof(uint64_t);

// A stage [k0, k0 + kPRows) of K lies in one half and one scale block (K/2
// is a multiple of 128); its block's dot is folded where the block or the
// half ends.
__device__ __forceinline__ bool prefill_fold(int k0, int kh) {
  const int end = k0 + kPRows;
  return end % kScaleBlock == 0 || end == kh;
}

__global__ void __launch_bounds__(kPThreads, 1)
int4_prefill_kernel(const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_s,
                    void* __restrict__ out, int out_f32, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kPStages * kPStageBytes);
  uint64_t* empty = full + kPStages;

  const int kh = K / 2;
  const int ksteps = K / kPRows;
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
  // the CTAs in flight share few column tiles, so each packed tile comes
  // from device memory about once and x stays in L2
  if (warp >= kPConsumerWarps) {
    // --------------------------------------------------------- producer
    sm90::setmaxnreg_dec<kPProducerRegs>();
    if (warp == kPConsumerWarps && lane == 0) {
      sm90::prefetch_map(&tm_w);
      sm90::prefetch_map(&tm_x);
      sm90::prefetch_map(&tm_s);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int col0 = tile / tok_tiles * kPCols;
        const int tok0 = tile % tok_tiles * kPTok;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int s = it % kPStages, k0 = ks * kPRows;
          const bool fold = prefill_fold(k0, kh);
          uint8_t* st = ring + s * kPStageBytes;
          sm90::mbar_wait(&empty[s], ((it / kPStages) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(
              &full[s], kPOffScale + (fold ? kPCols * 4 : 0));
          sm90::tma_load_2d(st, &tm_w, &full[s], col0, k0 < kh ? k0 : k0 - kh);
          // rows of x past M and columns past N read as zeros
#pragma unroll
          for (int b = 0; b < kPRows / 64; ++b)
            sm90::tma_load_3d(st + kPOffX + b * kPBoxBytes, &tm_x, &full[s],
                              k0 + 64 * b, tok0, 0);
          if (fold)
            sm90::tma_load_2d(st + kPOffScale, &tm_s, &full[s], col0,
                              k0 / kScaleBlock);
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  sm90::setmaxnreg_inc<kPConsumerRegs>();
  // warpgroup wg owns columns 64 wg.. of the tile; this thread's
  // accumulator rows are the columns cb and cb + 1 (int4_mma.cuh `wgmma_a`),
  // element 4j + e at column cb + (e >> 1), token 8j + 2t + (e & 1)
  const int g = lane >> 2, t = lane & 3;
  const int c16 = 64 * (warp >> 2) + 16 * (warp & 3);   // the warp's chunk
  const int cb = c16 + 2 * g;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.0f;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int col0 = tile / tok_tiles * kPCols;
    const int tok0 = tile % tok_tiles * kPTok;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    bool fresh = true;           // the next product starts a block's dot
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      const int s = it % kPStages, k0 = ks * kPRows;
      const int shift = k0 < kh ? 0 : 4;
      const uint8_t* st = ring + s * kPStageBytes;
      const uint32_t sx = sm90::smem_u32(st + kPOffX);
      // the wait before the products: a spin loop between two of them
      // would make ptxas serialize them
      sm90::mbar_wait(&full[s], (it / kPStages) & 1);
      // the stage's A fragments, then its products back to back; the
      // other warpgroup's products run while this one unpacks
      uint32_t v[kPRows / 32][4], a[kPRows / 16][4];
#pragma unroll
      for (int q = 0; q < kPRows / 32; ++q)
        int4mma::ldsm_pairs(v[q], st, 32 * q, c16);
#pragma unroll
      for (int kk = 0; kk < kPRows / 16; ++kk)
        int4mma::wgmma_a(a[kk], v[kk / 2][2 * (kk & 1)],
                         v[kk / 2][2 * (kk & 1) + 1], shift);
      sm90::fence_regs<kPRows / 4>(&a[0][0]);
      sm90::fence_regs<64>(part);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPRows / 16; ++kk) {
        const uint64_t db = sm90::desc(
            sx + (kk / 4) * kPBoxBytes + (kk % 4) * 32, 16, 1024);
        sm90::wgmma_rs_n128<0>(part, a[kk], db, !(fresh && kk == 0));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<64>(part);
      fresh = prefill_fold(k0, kh);
      if (fresh) {
        // acc += the block's dot x its column's scale (zeros past N)
        const float2 sc = *reinterpret_cast<const float2*>(
            reinterpret_cast<const float*>(st + kPOffScale) + cb);
#pragma unroll
        for (int i = 0; i < 64; ++i)
          acc[i] = fmaf(part[i], (i & 2) ? sc.y : sc.x, acc[i]);
      }
      // the ldmatrix and scale reads before the stage's TMA refill
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
    // out rows tok, tok + 1, columns col, col + 1: 32-bit stores, a warp's
    // 8 lanes of one t filling a 32-byte sector
    const int col = col0 + cb;
    if (col < N) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
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
  cudaError_t err = cudaFuncGetAttributes(&attr, int4_prefill_kernel);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs * kPThreads
      < 128 * kPProducerRegs + 32 * kPConsumerWarps * kPConsumerRegs)
    return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(
      int4_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kPrefillSmem);
  if (err != cudaSuccess) return (int)err;     // the ring cannot be had
  if (sm90::encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tw, tx, ts;
  if (!sm90::make_map_2d(&tw, w, 1, N, K / 2, kPCols, kPRows, true)
      || !sm90::make_map(&tx, x, K, M, 1, kPTok)
      || !sm90::make_map_2d(&ts, scale, 4, N, K / kScaleBlock, kPCols, 1,
                            false))
    return (int)cudaErrorInvalidValue;
  int4_prefill_kernel<<<ctas, kPThreads, kPrefillSmem, stream>>>(
      tw, tx, ts, out, out_f32, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, w (K/2, N) uint8, scale (K/256, N) f32, out (M, N) bf16
// (f32 where out_f32 is nonzero: the sums the bf16 store rounds), all
// contiguous, x, w and scale 16-byte aligned.  split_rows = 0 runs the
// prefill tile (any M) on a persistent grid of `splits` CTAs; else the
// decode tile (M <= 8) over `splits` ranges of split_rows packed rows (a
// multiple of 64, at most 1024) that cover K/2, the last one not empty.
// With split_rows > 0 and splits > 1, `partial` is an f32 (splits, M, N)
// workspace and `counters` one int per 128-column tile, zero before the
// call and zero again after it.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int groma_int4_matmul(const void* x, const void* w,
                                 const void* scale, void* out, void* partial,
                                 void* counters, int M, int K, int N,
                                 int split_rows, int splits, int out_f32,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < kScaleBlock || K % kScaleBlock || N < 64 || N % 64)
    return (int)cudaErrorInvalidValue;
  if (split_rows > 0)
    return launch_decode(x, w, scale, out, out_f32, partial, counters, M,
                         K, N, split_rows, splits, s);
  return launch_prefill(x, w, scale, out, out_f32, M, K, N, splits, s);
}
