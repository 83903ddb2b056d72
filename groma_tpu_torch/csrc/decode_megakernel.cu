// The whole L-layer int4 + int8-KV LLaMA decode step in one launch, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel groma_tpu/ops/decode_megakernel.py `_make_kernel`
// (entry `fused_decode_step`), one pallas_call with grid=(L,).  For each
// layer l, with x the f32 residual (B rows of D = 128 H, B <= 8):
//   1. h = bf16(rms(x) * ln1[l]); qkv = h @ Wqkv[l] (f32)
//   2. per (b, head): RoPE on the f32 q and k; q, k and v quantized to int8
//      per row (IEEE division by 127); attention over the int8 cache's old
//      positions plus this token, the softmax in f32, the v scale folded
//      into p, p requantized to int8, int32 p.v (this token's term added
//      before the f32 cast), times r / max(denom, 1e-30); then this token's
//      k and v written into the cache at the scalar slot `pos`;
//   3. x += bf16(attn) @ Wo[l]
//   4. h = bf16(rms(x) * ln2[l]); act = bf16(silu(g) * u), [g | u] = h @ Wgu[l]
//   5. x += act @ Wdown[l]
// The int4 products are int4_mma.cuh's: each 256-row block's dot on the
// exact integer weights, scaled after the dot, f32 sums, as on the TPU.
// The residual stays f32 across the layers.
//
// What bounds it: at B = 8 the bytes, 0.5 a weight read once (3.3 GB a step
// at the Vicuna-7B width, with the scales) and the KV cache up to pos (1.25
// GB at slot 580 of 1024): 1.37 ms at 3.35 TB/s.  The products are 2 B
// flops a weight, a few us of mma.sync.
//
// Design: one persistent cooperative kernel, one CTA per SM
// (cudaLaunchCooperativeKernel: a grid that cannot be co-resident is
// refused, never deadlocked), warp-specialised: one producer warp (one
// thread issues every copy) and eight consumer warps, 168 registers a
// thread.
//   * One stream.  Weights, scales and the old part of the KV cache do not
//     depend on the step's data (positions < pos are never written during
//     a step; an item writes its own column at pos after its reads), so the
//     producer walks the CTA's whole schedule, every layer and phase, and
//     keeps a kStages-deep mbarrier ring full; only a free slot stops it,
//     never a grid barrier.  When the consumers leave a barrier, the next
//     phase's first stages are already in shared memory: the TPU kernel's
//     double-buffered DMA and next-layer KV prefetch, on the copy engine.
//     A weight stage is a 64-packed-row x 128-column box (TMA, a 2-d map
//     per matrix and layer encoded when the params were stacked, 128-byte
//     swizzle) and, where a scale block of either nibble half ends, its
//     scale row (1-d bulk copy).  An attention stage is 64 k rows with
//     their k and v scales and mask entries, or 64 v rows (1-d bulk
//     copies: the rows of one (b, head) are contiguous).
//   * Balanced matmul work, planned on the host when the params are
//     stacked (ops/decode_megakernel.py `megakernel_plan`): the (128-column
//     tile, 64-row box) units of each matrix, tiles outer, cut into one
//     contiguous range a CTA, so every CTA streams the same bytes in every
//     phase to within one box; gate tile j and up tile F/128 + j are one
//     unit pair, so silu(g) u is formed where both are summed.  A range
//     that covers part of a tile is a split: its f32 partial goes to a
//     workspace, and the last CTA of the tile (an arrival counter that it
//     resets) adds the splits in order and runs the epilogue (qkv: f32;
//     o, down: + the residual, and the rows' sums of squares over the tile
//     for the next rms-norm; gate/up: bf16 silu(g) u).  No atomics enter a
//     sum: two calls give bitwise-equal outputs.
//   * Products on mma.sync m16n8k16 with the weights as A and the batch as
//     N = 8 (int4mma::step, load_b, fold): warp w runs k16 step w % 4 of
//     every box on the 64-column group w / 4; each half keeps its own
//     partial sums, folded with the block's scale where the block (or the
//     range) ends.  A box lies in one scale block of each half (K/2 is a
//     multiple of 128): down_proj's block 21, straddling K/2 = 5504, needs
//     no special case.
//   * Activations written inside the launch (x, qkv, attn, act) never go
//     through TMA (the async proxy would not see another SM's writes
//     without a proxy fence): after a barrier the consumers read the
//     columns that their segments need with ld.global.cg into the swizzled
//     8-row x 64-k tiles that load_b reads (each segment's, 32 boxes at a
//     time).  h = rms-norm(x) is formed there; its row scales come from the
//     sums of squares that the o and down epilogues left (from x itself at
//     the first layer).
//   * Attention items are (b, head), two at a time on the two groups of
//     four consumer warps, round-robin over the CTAs; the pair's stages are
//     interleaved in the ring, and a group's warps release only their own
//     (arriving twice each), so neither group waits for the other inside a
//     pair; the two meet between pairs (a full barrier is waited on by
//     parity, so no group may run a ring's length ahead of the other).  RoPE
//     and quantization as in the plain version, scores by dp4a from the
//     ring's k rows, the softmax in shared memory, p.v in int32 from the
//     ring's v rows.  A row whose token and old positions are all masked
//     takes p = 1 at all S positions (the TPU kernel's semantics) and
//     streams all S; any other row streams the positions before pos,
//     since those after it get p = 0 exactly.
//   * The grid barrier excludes the producer: a named barrier of the 256
//     consumer threads, then one thread's release add on a word whose top
//     bit flips when the last block arrives, and an acquire spin on it.
//     5 L - 1 barriers a step.  An mbarrier wait or a barrier spin traps
//     after about 2^34 clocks rather than hang.
//   * Optional stamps: %globaltimer at each block's start and end and at
//     each phase's end and barrier release (chip_smoke's phase split).
// Measured on an H100 while choosing this (development builds, not kept;
// the phase split and variants that drop one part of the work): HBM was
// not the limit.  Dropping the products saved the most time, dropping
// the x staging less, dropping the weight loads least: the consumers'
// instruction stream at two warps a scheduler, the x staging and the
// epilogues, during which a full ring stops the stream, set the pace.  The
// first version's barrier (a counter, a reset and a generation word, with
// fences) was slower than the present one; reading each score's mask entry
// from device memory made attention slower; staging all of x at every
// phase, not the segments' boxes, was a little slower; so was taking two
// boxes at a time, the second's loads and unpack under the first's
// products, and staging all eight rows of a chunk at once (ptxas spilled);
// raising the consumers' registers with setmaxnreg (a producer warpgroup
// at 40 to 72) made ptxas spill.  Two attention items at once that
// released each other's stages stalled each other and gained nothing
// until each group released only its own.
// Plain version and wrapper: groma_tpu_torch/ops/decode_megakernel.py.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "decode_common.cuh"
#include "int4_mma.cuh"
#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using decode::neg_inf;
using decode::sbyte;

constexpr int kConsumerWarps = 8;             // 4 k16 steps x 2 col groups
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;     // + the producer warp
constexpr int kMT = int4mma::kBatch;          // rows of the batch
constexpr int kHD = 128;                      // head dim
constexpr int kScaleBlock = 256;              // K rows per scale row
constexpr int kBox = int4mma::kTileRows;      // packed rows a box
constexpr int kCols = int4mma::kTileCols;     // columns a tile
constexpr int kRows = 64;                     // cache rows a stage
constexpr int kStages = 15;                   // depth of the ring
constexpr int kAux = int4mma::kTileBytes;     // a stage's scales follow
constexpr int kStageBytes = kAux + 1024;      // 9 KB
constexpr int kXWindow = 32;                  // boxes of x staged at once
constexpr int kXBytes = kXWindow * 2 * int4mma::kXTileBytes;    // 64 KB
constexpr int kRedBytes = kConsumerWarps * kMT * 64 * 4;         // 16 KB
constexpr int kGroups = 2;                    // attention items at once
constexpr int kGroupWarps = kConsumerWarps / kGroups;
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kSegInts = 8;                   // a plan segment's ints
constexpr int kMatrices = 4;                  // qkv, o, gate/up, down
constexpr int kPhases = 5;
constexpr float kNeg = -1e30f;
static_assert(kStageBytes % 1024 == 0, "swizzled boxes are 1024-aligned");
static_assert(kRows * kHD == kAux, "a stage holds 64 cache rows");

struct Params {
  const float* x0;                 // (B, D) the hidden state after embedding
  float* x;                        // (B, D) the f32 residual, the output
  const float* cos;                // (B, 128) RoPE rows at this position
  const float* sin;
  const float* mask;               // (B, S) bias over the old positions
  const float* cur;                // (B,) bias of this token
  const float* ln1;                // (L, D)
  const float* ln2;
  const unsigned long long* wtab;  // (L, 8): wqkv sqkv wo so wgu sgu wdn sdn
  const CUtensorMap* maps;         // (L, 4): the packed weights' TMA maps
  const unsigned long long* ctab;  // (L, 4): k8 ks v8 vs
  const int* plan;                 // megakernel_plan: offsets, segments
  float* qkv;                      // (B, 3 D) scratch
  bf16* attn;                      // (B, D) scratch
  bf16* act;                       // (B, F) scratch
  float* ssq;                      // (D / 128, 8) x's sums of squares
  float* part;                     // split-K partials
  unsigned* sync;                  // the barrier word; tile counters
  unsigned long long* stamps;      // null, or (grid, 2 + 10 L) timestamps
  const int* pos;                  // the cache slot of this token, read
                                   // when the launch runs (a graph replays
                                   // the launch at the slot it then holds)
  int L, B, H, S, F, xbytes;
  float eps, scale;
};

// Matrix m of a layer: K, N, and whether its tiles are gate/up pairs.
struct Mat {
  int K, N, pair;
};

__device__ __forceinline__ Mat matrix(const Params& p, int m) {
  const int D = p.H * kHD;
  return m == 0 ? Mat{D, 3 * D, 0} : m == 1 ? Mat{D, D, 0}
         : m == 2 ? Mat{D, 2 * p.F, 1} : Mat{p.F, D, 0};
}

// A plan segment: boxes [box0, box1) of column tile (or gate/up pair)
// `tile`, split `split` of `splits`, its partial at workspace slot `slot`.
struct Seg {
  int tile, box0, box1, split, splits, slot;
};

__device__ __forceinline__ Seg segment(const int* seg) {
  return Seg{__ldg(seg), __ldg(seg + 1), __ldg(seg + 2), __ldg(seg + 3),
             __ldg(seg + 4), __ldg(seg + 5)};
}

// The segments [first, last) of this CTA in matrix m.
__device__ __forceinline__ void segments(const Params& p, int m, int& first,
                                         int& last) {
  const int* off = p.plan + m * (gridDim.x + 1) + blockIdx.x;
  first = __ldg(off);
  last = __ldg(off + 1);
}

__device__ __forceinline__ const int* seg_ptr(const Params& p, int g) {
  return p.plan + kMatrices * (gridDim.x + 1) + g * kSegInts;
}

// The first column of tile `tile` of matrix mt; of a gate/up pair, its
// gate (sub 0) or up (sub 1) tile.
__device__ __forceinline__ int tile_col(const Params& p, const Mat& mt,
                                        int tile, int sub) {
  return (mt.pair && sub ? p.F : 0) + tile * kCols;
}

__device__ __forceinline__ bool fold_at(int r, int kh, int half, bool last) {
  return last || (r + kBox + half * kh) % kScaleBlock == 0;
}

// A group's attention scratch: S f32 scores, S f32 v scales, S int8 p.
__host__ __device__ __forceinline__ int attn_scratch(int S) {
  return (9 * S + 15) & ~15;
}

// The slot this step writes: written before the launch, never during it.
__device__ __forceinline__ int slot(const Params& p) { return __ldg(p.pos); }

// Cache rows that item row b reads: all S when its token and old positions
// are masked (p = 1 everywhere), else those before pos.
__device__ __forceinline__ int cache_rows(const Params& p, int b) {
  return __ldg(p.cur + b) > 0.5f * kNeg ? slot(p) : p.S;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Add with release (acq_rel) semantics at gpu scope; returns the old value.
// After a bar.sync, one thread's release publishes the CTA's writes.
__device__ __forceinline__ unsigned add_release(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ float ld_l2(const float* p) { return __ldcg(p); }

// Two attention items at once (groups 0 and 1 of the consumer warps):
// item i0 and i0 + grid.  Their ring stages (an item's k stages, then its
// v stages: len = 2 ceil(rows / 64) each) are interleaved, 0 1 0 1 ..., the
// longer one's rest last.  `base` is the ring index of the pair's first
// stage.
struct Pair {
  uint32_t base;
  int len[kGroups];
};

__device__ __forceinline__ Pair pair_of(const Params& p, int i0,
                                        uint32_t base) {
  Pair pr{base, {0, 0}};
  for (int g = 0; g < kGroups; ++g) {
    const int item = i0 + g * (int)gridDim.x;
    if (item < p.B * p.H)
      pr.len[g] = 2 * ((cache_rows(p, item / p.H) + kRows - 1) / kRows);
  }
  return pr;
}

// Stage k of the pair: stage j of group g's item.
__device__ __forceinline__ int pair_len(const Pair& pr, int g) {
  return g ? pr.len[1] : pr.len[0];
}

__device__ __forceinline__ void pair_stage(const Pair& pr, int k, int& g,
                                           int& j) {
  const int mn = min(pr.len[0], pr.len[1]);
  if (k < 2 * mn) {
    g = k & 1;
    j = k >> 1;
  } else {
    g = pr.len[0] > pr.len[1] ? 0 : 1;
    j = mn + (k - 2 * mn);
  }
}

// ------------------------------------------------------------- producer

// A k stage's aux bytes: its k scales, v scales and mask entries, each the
// 16-byte-aligned cover of the stage's rows (at most 70 floats).  The
// wrapper refuses tensors whose base is not 16-byte aligned, so a cover
// lies in the 16-byte granules that hold the rows: where S is not a
// multiple of 4 it reads up to 12 bytes past the tensor's end, inside the
// granule (and so the page) of its last element.
constexpr int kAuxKs = kAux, kAuxVs = kAux + 320, kAuxMask = kAux + 640;

__device__ __forceinline__ size_t cover(size_t i) { return i & ~(size_t)3; }

__device__ __forceinline__ uint32_t cover_bytes(size_t i, int n) {
  return (uint32_t)(((i + n + 3) & ~(size_t)3) - cover(i)) * 4;
}

struct Ring {
  uint8_t* buf;
  uint64_t* full;
  uint64_t* empty;
  uint32_t it;                     // stages filled (producer) or used
};

// The next slot, once free; its full barrier expects `bytes`.
__device__ __forceinline__ uint8_t* fill(Ring& r, uint32_t bytes) {
  const int s = r.it % kStages;
  sm90::mbar_wait(&r.empty[s], ((r.it / kStages) & 1) ^ 1);
  sm90::mbar_arrive_expect_tx(&r.full[s], bytes);
  return r.buf + s * kStageBytes;
}

__device__ __forceinline__ uint64_t* filling(Ring& r) {
  return &r.full[r.it % kStages];
}

// One thread walks the CTA's whole schedule, in the consumers' order.
__device__ void produce(const Params& p, Ring& r) {
  const int S = p.S, G = gridDim.x;
  for (int l = 0; l < p.L; ++l) {
    const unsigned long long* wt = p.wtab + 8 * l;
    const unsigned long long* ct = p.ctab + 4 * l;
    for (int m = 0; m < kMatrices; ++m)
      sm90::prefetch_map(p.maps + kMatrices * l + m);
    for (int ph = 0; ph < kPhases; ++ph) {
      if (ph == 1) {
        // attention: the CTA's items two at a time, their stages
        // interleaved (pair_stage); an item's stages are its k rows with
        // their k and v scales and mask entries, then its v rows
        const uint8_t* k8 = reinterpret_cast<const uint8_t*>(ct[0]);
        const float* ks = reinterpret_cast<const float*>(ct[1]);
        const uint8_t* v8 = reinterpret_cast<const uint8_t*>(ct[2]);
        const float* vs = reinterpret_cast<const float*>(ct[3]);
        for (int i0 = blockIdx.x; i0 < p.B * p.H; i0 += kGroups * G) {
          const Pair pr = pair_of(p, i0, r.it);
          for (int k = 0; k < pr.len[0] + pr.len[1]; ++k, ++r.it) {
            int g, j;
            pair_stage(pr, k, g, j);
            const int item = i0 + g * G, b = item / p.H;
            const int ns = pair_len(pr, g) / 2;
            const size_t row0 = (size_t)item * S;         // item = b H + h
            const int j0 = (j % ns) * kRows;
            const int cnt = min(kRows, cache_rows(p, b) - j0);
            if (j >= ns) {
              uint8_t* st = fill(r, cnt * kHD);
              sm90::bulk_load(st, v8 + (row0 + j0) * kHD, cnt * kHD,
                              filling(r));
              continue;
            }
            // the 16-byte-aligned covers of the scales and the mask
            // entries of rows [j0, j0 + cnt)
            const size_t a0 = cover(row0 + j0), m0 = cover((size_t)b * S + j0);
            const uint32_t sb = cover_bytes(row0 + j0, cnt);
            const uint32_t mb = cover_bytes((size_t)b * S + j0, cnt);
            uint8_t* st = fill(r, cnt * kHD + 2 * sb + mb);
            sm90::bulk_load(st, k8 + (row0 + j0) * kHD, cnt * kHD,
                            filling(r));
            sm90::bulk_load(st + kAuxKs, ks + a0, sb, filling(r));
            sm90::bulk_load(st + kAuxVs, vs + a0, sb, filling(r));
            sm90::bulk_load(st + kAuxMask, p.mask + m0, mb, filling(r));
          }
        }
        continue;
      }
      const int m = ph == 0 ? 0 : ph - 1;
      const Mat mt = matrix(p, m);
      const int kh = mt.K / 2;
      const CUtensorMap* map = p.maps + kMatrices * l + m;
      const float* scale = reinterpret_cast<const float*>(wt[2 * m + 1]);
      int first, last;
      segments(p, m, first, last);
      for (int g = first; g < last; ++g) {
        const Seg sg = segment(seg_ptr(p, g));
        for (int sub = 0; sub <= mt.pair; ++sub) {
          const int col0 = tile_col(p, mt, sg.tile, sub);
          for (int bx = sg.box0; bx < sg.box1; ++bx, ++r.it) {
            const int row = bx * kBox;
            const bool end = bx + 1 == sg.box1;
            const bool lo = fold_at(row, kh, 0, end);
            const bool hi = fold_at(row, kh, 1, end);
            uint8_t* st = fill(r, kAux + (lo + hi) * kCols * 4);
            sm90::tma_load_2d(st, map, filling(r), col0, row);
            if (lo)
              sm90::bulk_load(st + kAux,
                              scale + (size_t)(row / kScaleBlock) * mt.N
                                  + col0,
                              kCols * 4, filling(r));
            if (hi)
              sm90::bulk_load(st + kAux + 512,
                              scale + (size_t)((row + kh) / kScaleBlock)
                                          * mt.N + col0,
                              kCols * 4, filling(r));
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------ consumers

__device__ __forceinline__ void consumers_sync() {
  sm90::named_sync(1, kConsumers);
}

// Wait for stage r.it; returns its data.
__device__ __forceinline__ const uint8_t* take(Ring& r) {
  const int s = r.it % kStages;
  sm90::mbar_wait(&r.full[s], (r.it / kStages) & 1);
  return r.buf + s * kStageBytes;
}

// This warp is done with stage r.it: its reads are ordered before the
// stage's bulk-copy refill, then lane 0 arrives.
__device__ __forceinline__ void release(Ring& r) {
  sm90::fence_proxy_async();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(&r.empty[r.it % kStages]);
  ++r.it;
}

// The grid barrier of the consumer warps; `idx` is this wait's stamp.
// Every block adds 1 to the word, block 0 adds 2^31 - (grid - 1): its top
// bit flips when the last block arrives, and its low bits stay 0 for the
// next barrier and the next launch.
__device__ void grid_wait(const Params& p, unsigned long long* stamp,
                          int idx) {
  consumers_sync();
  if (threadIdx.x == 0) {
    if (stamp) stamp[idx] = globaltimer();
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    const unsigned old = add_release(p.sync, add);
    const long long start = clock64();
    for (int spins = 1; ((ld_acquire(p.sync) ^ old) & 0x80000000u) == 0;
         ++spins)
      if ((spins & 1023) == 0 && clock64() - start > (1ll << 34)) __trap();
    if (stamp) stamp[idx + 1] = globaltimer();
  }
  consumers_sync();
}

// rs[m] = 1 / rms(x[m]) for m < B: warp m sums row m.
__device__ void row_scales(const float* x, int B, int D, float eps,
                           float* rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < B) {
    const float4* row = reinterpret_cast<const float4*>(x + (size_t)warp * D);
    float ss = 0.0f;
#pragma unroll 8
    for (int i = lane; i < D / 4; i += 32) {
      const float4 v = __ldcg(row + i);
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
      ss = fmaf(v.z, v.z, ss);
      ss = fmaf(v.w, v.w, ss);
    }
    ss = decode::warp_sum(ss);
    if (lane == 0)
      rs[warp] = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)D), eps));
  } else if (lane == 0) {
    rs[warp] = 0.0f;                      // rows past B stay zero
  }
  consumers_sync();
}

// rs[m] = 1 / rms(x[m]) for m < B from the sums of squares that the
// epilogues of the D / 128 column tiles left, added in tile order.
__device__ void row_scales_ssq(const float* ssq, int B, int D, float eps,
                               float* rs) {
  const int tid = threadIdx.x;
  if (tid < kMT) {
    float ss = 0.0f;
    for (int t = 0; t < D / kCols && tid < B; ++t)
      ss += __ldcg(ssq + t * kMT + tid);
    rs[tid] = tid < B ? __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)D), eps))
                      : 0.0f;
  }
  consumers_sync();
}

__device__ __forceinline__ uint32_t rms_pair(float a, float b, float r,
                                             float ga, float gb) {
  return sm90::pack_bf16(__fmul_rn(__fmul_rn(a, r), ga),
                         __fmul_rn(__fmul_rn(b, r), gb));
}

// x's k columns [64 wb, 64 (wb + nb)) and [kh + 64 wb, ...) as the
// swizzled 8-row x 64-k tiles that load_b reads: tile 2 i (low half) and
// 2 i + 1 (high half) of box wb + i; rows past B are zeros.  The source is
// bf16 rows of device memory (`src`), or, with `ln`, rms-norm(xres) * ln.
// A thread takes 8 columns of every row at a time (ln read once).
__device__ __forceinline__ void stage_x(uint8_t* xbuf, const bf16* src,
                                        const float* xres, const float* ln,
                                        const float* rs, int K, int B,
                                        int wb, int nb) {
  const int kh = K / 2, n = nb * 2 * 8;             // 8-column chunks
  for (int q = threadIdx.x; q < n; q += kConsumers) {
    const int tile = q >> 3, ch = q & 7;
    const int k = (tile & 1) * kh + (wb + (tile >> 1)) * kBox + ch * 8;
    uint8_t* dst = xbuf + tile * int4mma::kXTileBytes;
    if (ln == nullptr) {
      uint4 v[kMT];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        v[m] = m < B ? __ldcg(reinterpret_cast<const uint4*>(
                           src + (size_t)m * K + k))
                     : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        *reinterpret_cast<uint4*>(dst + m * 128 + ((ch ^ m) & 7) * 16) =
            v[m];
      continue;
    }
    const float4* gr = reinterpret_cast<const float4*>(ln + k);
    const float4 ga = __ldg(gr), gb = __ldg(gr + 1);
    // four rows' loads in flight at a time
#pragma unroll
    for (int h = 0; h < kMT; h += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        a[m] = b[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (h + m < B) {
          const float4* xr = reinterpret_cast<const float4*>(
              xres + (size_t)(h + m) * K + k);
          a[m] = __ldcg(xr);
          b[m] = __ldcg(xr + 1);
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float r = rs[h + m];          // 0 past B
        *reinterpret_cast<uint4*>(dst + (h + m) * 128
                                  + ((ch ^ (h + m)) & 7) * 16) =
            make_uint4(rms_pair(a[m].x, a[m].y, r, ga.x, ga.y),
                       rms_pair(a[m].z, a[m].w, r, ga.z, ga.w),
                       rms_pair(b[m].x, b[m].y, r, gb.x, gb.y),
                       rms_pair(b[m].z, b[m].w, r, gb.z, gb.w));
      }
    }
  }
}

// One attention group's (b, head): roped q and k, v, their int8 rows and
// scales, this token's score, the group's reduction slots.
struct Att {
  __align__(16) float qf[kHD];
  __align__(16) float kf[kHD];
  __align__(16) float vf[kHD];
  uint32_t q8[kHD / 4], k8[kHD / 4], v8[kHD / 4];
  float qs, ks, vs, s_cur;
  float bred[kGroupWarps];
};

struct Smem {
  uint8_t* xbuf;                   // x tiles, or the attention scratch
  float* red;                      // the k-step sums, or p.v's
  float rs[kMT];                   // 1 / rms of each row
  float tsq[kMT][4];               // a tile's sums of squares, by warp
  int last;
  Att att[kGroups];
};

constexpr int kPerThread = kMT * kCols / kConsumers;   // outputs a tile

// The residual that the epilogue of column tile `tile` of o or down adds
// to output o = tid + 256 q, loaded ahead of the tile's sums.
__device__ __forceinline__ void residual(const Params& p, int l, int m,
                                         int tile, float* xr) {
  const int D = p.H * kHD;
  const float* xin = (m == 1 && l == 0) ? p.x0 : p.x;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int o = threadIdx.x + q * kConsumers;
    xr[q] = o / kCols < p.B
        ? ld_l2(xin + (size_t)(o / kCols) * D + tile * kCols + o % kCols)
        : 0.0f;
  }
}

// The epilogue of column tile `tile` of matrix m: output o = tid + 256 q
// (row o / 128, column 128 tile + o % 128) has the sum v[q] (the up sum,
// beside the gate's g[q], for gate/up).  qkv: f32; gate/up: bf16 silu(g)
// u; o and down: x = xr + v (xr from `residual`), and the rows' sums of
// squares over the tile's columns into ssq, for the next rms-norm.
__device__ void finish(const Params& p, int m, int tile, const float* v,
                       const float* g, const float* xr, Smem& sh) {
  const int D = p.H * kHD, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5;
  float sq[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int o = tid + q * kConsumers;
    const int row = o / kCols, col = tile * kCols + o % kCols;
    sq[q] = 0.0f;
    if (row >= p.B) continue;
    if (m == 0) {
      p.qkv[(size_t)row * 3 * D + col] = v[q];
    } else if (m == 2) {
      const float silu = __fdiv_rn(g[q], __fadd_rn(1.0f, expf(-g[q])));
      p.act[(size_t)row * p.F + col] =
          __float2bfloat16(__fmul_rn(silu, v[q]));
    } else {
      const float xn = __fadd_rn(xr[q], v[q]);
      p.x[(size_t)row * D + col] = xn;
      sq[q] = __fmul_rn(xn, xn);
    }
  }
  if (m == 0 || m == 2) return;
  // warp w holds columns 32 (w % 4).. of row w / 4 + 2 q
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const float s = decode::warp_sum(sq[q]);
    if (lane == 0) sh.tsq[warp / 4 + 2 * q][warp % 4] = s;
  }
  consumers_sync();
  if (tid < p.B)
    p.ssq[tile * kMT + tid] = ((sh.tsq[tid][0] + sh.tsq[tid][1])
                               + sh.tsq[tid][2]) + sh.tsq[tid][3];
}

// The matmul phase of matrix m in layer l: this CTA's segments.  Each
// segment stages its boxes' x columns, 32 boxes at a time (box b of the
// window at tiles 2 b and 2 b + 1); a gate/up segment of at most 32 boxes
// stages them once for its gate and its up tile.
__device__ void matmul_phase(const Params& p, int l, int m, Ring& r,
                             Smem& sh) {
  int first, last;
  segments(p, m, first, last);
  if (first == last) return;
  const Mat mt = matrix(p, m);
  const int kh = mt.K / 2, D = p.H * kHD, B = p.B;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int ks = warp & 3, c0 = (warp >> 2) * 64;
  const float* ln = nullptr;
  const float* xres = nullptr;
  const bf16* src = m == 1 ? p.attn : p.act;
  if (m == 0 || m == 2) {
    ln = (m == 0 ? p.ln1 : p.ln2) + (size_t)l * D;
    xres = (m == 0 && l == 0) ? p.x0 : p.x;
    if (m == 0 && l == 0)
      row_scales(xres, B, D, p.eps, sh.rs);
    else
      row_scales_ssq(p.ssq, B, D, p.eps, sh.rs);
  }
  const int width = mt.pair + 1;
  for (int g = first; g < last; ++g) {
    const Seg sg = segment(seg_ptr(p, g));
    const bool whole = sg.box1 - sg.box0 <= kXWindow;
    float sum[kPerThread] = {}, gate[kPerThread], xr[kPerThread] = {};
    for (int sub = 0; sub < width; ++sub) {
      float acc[4][4], part_lo[4][4], part_hi[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = part_lo[j][e] = part_hi[j][e] = 0.0f;
      for (int bx = sg.box0; bx < sg.box1; ++bx) {
        const int xt = (bx - sg.box0) % kXWindow;    // the box's x tiles
        if (xt == 0 && (sub == 0 || !whole)) {
          consumers_sync();                  // the x tiles are free
          stage_x(sh.xbuf, src, xres, ln, sh.rs, mt.K, B, bx,
                  min(kXWindow, sg.box1 - bx));
          consumers_sync();
        }
        const int row = bx * kBox;
        const bool end = bx + 1 == sg.box1;
        const uint8_t* st = take(r);
        uint32_t b_lo[2], b_hi[2];
        int4mma::load_b(b_lo, sh.xbuf + 2 * xt * int4mma::kXTileBytes,
                        16 * ks);
        int4mma::load_b(b_hi, sh.xbuf + (2 * xt + 1) * int4mma::kXTileBytes,
                        16 * ks);
        int4mma::step(st, 16 * ks, c0, b_lo, b_hi, part_lo, part_hi);
        const float* sc = reinterpret_cast<const float*>(st + kAux) + c0
                          + 4 * gq;
        if (fold_at(row, kh, 0, end))
          int4mma::fold(acc, part_lo, *reinterpret_cast<const float4*>(sc),
                        *reinterpret_cast<const float4*>(sc + 32));
        if (fold_at(row, kh, 1, end))
          int4mma::fold(acc, part_hi,
                        *reinterpret_cast<const float4*>(sc + kCols),
                        *reinterpret_cast<const float4*>(sc + kCols + 32));
        release(r);
      }
      if ((m == 1 || m == 3) && sub == 0) residual(p, l, m, sg.tile, xr);
      // the four k-step warps of a column group, in a fixed order:
      // red[warp][m][64]
      consumers_sync();
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mr = 2 * t + (e & 1);
        *reinterpret_cast<float4*>(sh.red + (warp * kMT + mr) * 64
                                   + 32 * (e >> 1) + 4 * gq) =
            make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
      }
      consumers_sync();
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int o = tid + q * kConsumers;
        const int c = o % kCols;
        const float* v = sh.red + ((c / 64) * 4 * kMT + o / kCols) * 64
                         + c % 64;
        gate[q] = sum[q];
        sum[q] = ((v[0] + v[kMT * 64]) + v[2 * kMT * 64]) + v[3 * kMT * 64];
        if (sg.splits > 1 && o / kCols < B)
          p.part[((size_t)sg.slot * width + sub) * kMT * kCols + o] = sum[q];
      }
    }
    if (sg.splits == 1) {
      finish(p, m, sg.tile, sum, gate, xr, sh);
      continue;
    }
    // split K: the last CTA of the tile adds the splits in order
    consumers_sync();
    if (tid == 0) {
      unsigned* counter = p.sync + 1 + sg.tile;
      sh.last = add_acq_rel(counter, 1u) == (unsigned)sg.splits - 1;
      if (sh.last) *counter = 0;              // ready for the next phase
    }
    consumers_sync();
    if (!sh.last) continue;
    const int slot0 = sg.slot - sg.split;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int o = tid + q * kConsumers;
      float s2[2] = {0.0f, 0.0f};
      // unrolled, so that the loads of several splits are in flight at once
      if (o / kCols < B)
#pragma unroll 8
        for (int z = 0; z < sg.splits; ++z)
          for (int sub = 0; sub < width; ++sub)
            s2[sub] += __ldcg(p.part + ((size_t)(slot0 + z) * width + sub)
                                           * kMT * kCols + o);
      gate[q] = s2[0];
      sum[q] = s2[width - 1];
    }
    finish(p, m, sg.tile, sum, gate, xr, sh);
  }
}

__device__ __forceinline__ uint32_t qbyte(float x, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.0f), 127.0f);
  return (uint32_t)((int)q & 0xff);
}

// One warp quantizes a 128-wide row symmetrically: lane l packs values
// 4l..4l+3 into q8[l]; returns the scale max|x| / 127 (1 for a zero row).
__device__ __forceinline__ float quant_row(const float* x, uint32_t* q8) {
  const int lane = threadIdx.x & 31;
  const float4 v = reinterpret_cast<const float4*>(x)[lane];
  const float a = decode::warp_max(fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                                         fmaxf(fabsf(v.z), fabsf(v.w))));
  const float s = a > 0.0f ? __fdiv_rn(a, 127.0f) : 1.0f;
  q8[lane] = qbyte(v.x, s) | (qbyte(v.y, s) << 8) | (qbyte(v.z, s) << 16) |
             (qbyte(v.w, s) << 24);
  return s;
}

__device__ __forceinline__ void group_sync(int g) {
  sm90::named_sync(2 + g, kGroupThreads);
}

__device__ __forceinline__ float group_max(float v, float* red, int g) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) % kGroupWarps;
  v = decode::warp_max(v);
  if (lane == 0) red[warp] = v;
  group_sync(g);
  v = decode::warp_max(lane < kGroupWarps ? red[lane] : neg_inf());
  group_sync(g);
  return v;
}

__device__ __forceinline__ float group_sum(float v, float* red, int g) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) % kGroupWarps;
  v = decode::warp_sum(v);
  if (lane == 0) red[warp] = v;
  group_sync(g);
  v = decode::warp_sum(lane < kGroupWarps ? red[lane] : 0.0f);
  group_sync(g);
  return v;
}

// Stage j of group g's item, once filled.  Only the owning group reads a
// stage: its warps arrive twice each on the slot's empty barrier, whose
// count is all the consumer warps, so the other group never waits for it.
__device__ __forceinline__ const uint8_t* take_own(const Pair& pr, int g,
                                                   int j, Ring& r) {
  const int mn = min(pr.len[0], pr.len[1]);
  r.it = pr.base + (j < mn ? 2 * j + g : 2 * mn + (j - mn));
  return take(r);
}

__device__ __forceinline__ void release_own(Ring& r) {
  sm90::fence_proxy_async();
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;"
                 :: "r"(sm90::smem_u32(&r.empty[r.it % kStages])),
                    "r"(kGroups) : "memory");
}

// Phase 2 for one (b, head) of layer l on group g's 128 threads, its cache
// rows from the ring (stages j of the pair's group g).
__device__ void attend(const Params& p, int l, int b, int h, int g,
                       const Pair& pr, Ring& r, Smem& sh) {
  const int tid = threadIdx.x % kGroupThreads, lane = tid & 31;
  const int warp = tid >> 5;
  const int D = p.H * kHD, S = p.S, pos = slot(p);
  const unsigned long long* ct = p.ctab + 4 * l;
  int8_t* k8 = reinterpret_cast<int8_t*>(ct[0]);
  float* ks = reinterpret_cast<float*>(ct[1]);
  int8_t* v8 = reinterpret_cast<int8_t*>(ct[2]);
  float* vs = reinterpret_cast<float*>(ct[3]);
  const size_t bh = (size_t)b * p.H + h;
  Att& at = sh.att[g];
  float* scores = reinterpret_cast<float*>(
      sh.xbuf + g * attn_scratch(S));                     // S floats
  float* vsc = scores + S;                                // S v scales
  int8_t* p8 = reinterpret_cast<int8_t*>(vsc + S);        // S bytes
  int* red_o = reinterpret_cast<int*>(sh.red) + g * kGroupWarps * kHD;

  group_sync(g);                        // the previous item's scratch
  // 1. RoPE (half rotation) on the f32 q and k; v as it is
  {
    const float* row = p.qkv + (size_t)b * 3 * D + h * kHD;
    const int i = tid, half = kHD / 2;
    const float c = __ldg(p.cos + b * kHD + i), s = __ldg(p.sin + b * kHD + i);
    const int o = i < half ? i + half : i - half;
    const float sign = i < half ? -1.0f : 1.0f;
    at.qf[i] = __fadd_rn(__fmul_rn(ld_l2(row + i), c),
                         __fmul_rn(sign * ld_l2(row + o), s));
    at.kf[i] = __fadd_rn(__fmul_rn(ld_l2(row + D + i), c),
                         __fmul_rn(sign * ld_l2(row + D + o), s));
    at.vf[i] = ld_l2(row + 2 * D + i);
  }
  group_sync(g);
  // 2. q, k and v quantized per row, one warp each
  if (warp < 3) {
    const float* src = warp == 0 ? at.qf : warp == 1 ? at.kf : at.vf;
    uint32_t* dst = warp == 0 ? at.q8 : warp == 1 ? at.k8 : at.v8;
    const float s = quant_row(src, dst);
    if (lane == 0) *(warp == 0 ? &at.qs : warp == 1 ? &at.ks : &at.vs) = s;
  }
  group_sync(g);
  const float qscale = __fmul_rn(at.qs, p.scale);
  // 3. this token's score
  if (warp == 0) {
    int dot = __dp4a((int)at.q8[lane], (int)at.k8[lane], 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0)
      at.s_cur = __fadd_rn(__fmul_rn(__fmul_rn((float)dot, qscale), at.ks),
                           __ldg(p.cur + b));
  }
  // 4. the old positions' scores, 64 rows a stage: 8 lanes a 128-byte key
  //    row, 4 rows a warp at a time; the v scales kept for step 5
  const int n = cache_rows(p, b), ns = (n + kRows - 1) / kRows;
  const int sub = lane & 7, row_in_warp = lane >> 3;
  const uint4 qw = make_uint4(at.q8[4 * sub], at.q8[4 * sub + 1],
                              at.q8[4 * sub + 2], at.q8[4 * sub + 3]);
  float local_max = neg_inf();
  for (int j = 0; j < ns; ++j) {
    const int j0 = j * kRows, cnt = min(kRows, n - j0);
    const uint8_t* st = take_own(pr, g, j, r);
    const int skew = (int)((bh * S + j0) & 3);
    const float* ksr = reinterpret_cast<const float*>(st + kAuxKs) + skew;
    const float* vsr = reinterpret_cast<const float*>(st + kAuxVs) + skew;
    const float* msr = reinterpret_cast<const float*>(st + kAuxMask)
                       + (int)(((size_t)b * S + j0) & 3);
#pragma unroll
    for (int pass = 0; pass < kRows / (4 * kGroupWarps); ++pass) {
      const int i = pass * 4 * kGroupWarps + warp * 4 + row_in_warp;
      int dot = 0;
      if (i < cnt)
        dot = decode::dot16(
            *reinterpret_cast<const uint4*>(st + i * kHD + sub * 16), qw);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      if (i < cnt && sub == 0) {
        const float s = __fadd_rn(
            __fmul_rn(__fmul_rn((float)dot, qscale), ksr[i]), msr[i]);
        scores[j0 + i] = s;
        local_max = fmaxf(local_max, s);
      }
    }
    if (tid < cnt) vsc[j0 + tid] = vsr[tid];
    release_own(r);
  }
  const float m = fmaxf(group_max(local_max, at.bred, g), at.s_cur);

  // 5. exp, the denominator, the v scale folded into p, p requantized
  float dsum = 0.0f, rmax = 0.0f;
  for (int j = tid; j < n; j += kGroupThreads) {
    const float pj = expf(__fsub_rn(scores[j], m));
    dsum += pj;
    const float ps = __fmul_rn(pj, vsc[j]);
    scores[j] = ps;
    rmax = fmaxf(rmax, ps);
  }
  const float p_cur = expf(__fsub_rn(at.s_cur, m));
  const float denom = __fadd_rn(group_sum(dsum, at.bred, g), p_cur);
  const float ps_cur = __fmul_rn(p_cur, at.vs);
  float rq = fmaxf(group_max(rmax, at.bred, g), ps_cur);
  rq = rq > 0.0f ? __fdiv_rn(rq, 127.0f) : 1.0f;
  for (int j = tid; j < n; j += kGroupThreads)
    p8[j] = (int8_t)(int)rintf(__fdiv_rn(scores[j], rq));
  const int p8c = (int)rintf(__fdiv_rn(ps_cur, rq));
  group_sync(g);

  // 6. p.v in int32, 64 rows a stage: a thread owns 16 dims of one row
  const int dg = tid & 7;
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  for (int j = 0; j < ns; ++j) {
    const int j0 = j * kRows, cnt = min(kRows, n - j0);
    const uint8_t* st = take_own(pr, g, ns + j, r);
#pragma unroll
    for (int pass = 0; pass < kRows / (kGroupThreads / 8); ++pass) {
      const int i = pass * (kGroupThreads / 8) + (tid >> 3);
      if (i < cnt) {
        const uint4 vw =
            *reinterpret_cast<const uint4*>(st + i * kHD + dg * 16);
        const int pj = p8[j0 + i];
        const uint32_t words[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * wi + e] += pj * sbyte(words[wi], e);
      }
    }
    release_own(r);
  }
  // lanes sharing dg differ in bits 3..4 of the lane id
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int v = acc[j];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    acc[j] = v;
  }
  if (lane < 8) {
#pragma unroll
    for (int j = 0; j < 16; ++j) red_o[warp * kHD + dg * 16 + j] = acc[j];
  }
  group_sync(g);
  {
    int o = p8c * sbyte(at.v8[tid / 4], tid % 4);
#pragma unroll
    for (int wi = 0; wi < kGroupWarps; ++wi) o += red_o[wi * kHD + tid];
    const float val = __fmul_rn((float)o,
                                __fdiv_rn(rq, fmaxf(denom, 1e-30f)));
    p.attn[(size_t)b * D + h * kHD + tid] = __float2bfloat16(val);
  }
  // 7. this token's k and v into the cache at pos, after every read
  if (tid < kHD / 4) {
    reinterpret_cast<uint32_t*>(k8 + (bh * S + pos) * kHD)[tid] = at.k8[tid];
    reinterpret_cast<uint32_t*>(v8 + (bh * S + pos) * kHD)[tid] = at.v8[tid];
  }
  if (tid == 0) {
    ks[bh * S + pos] = at.ks;
    vs[bh * S + pos] = at.vs;
  }
}

// The attention phase of layer l: this CTA's items i0 = c, c + 2 grid, ...
// and i0 + grid beside each, on consumer groups 0 and 1.  Between two pairs
// both groups meet: a stage's full barrier is waited on by parity alone, so
// a group must not wait on stage X before stage X - kStages was filled.
// Within a pair a group's next stage is at most two past its last; across
// pairs, without the meeting, a group whose item was short would jump to
// the next pair's first stage while the other still held a stage more than
// kStages before it, and could read the slot's older fill.
__device__ void attention_phase(const Params& p, int l, Ring& r, Smem& sh) {
  const int G = gridDim.x, BH = p.B * p.H;
  const int g = (threadIdx.x >> 5) / kGroupWarps;
  for (int i0 = blockIdx.x; i0 < BH; i0 += kGroups * G) {
    const Pair pr = pair_of(p, i0, r.it);
    const int item = i0 + g * G;
    if (item < BH) attend(p, l, item / p.H, item % p.H, g, pr, r, sh);
    r.it = pr.base + pr.len[0] + pr.len[1];
    if (i0 + kGroups * G < BH) consumers_sync();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
decode_megakernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Smem sh;
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  Ring r;
  r.buf = base;
  r.it = 0;
  uint8_t* xbuf = base + kStages * kStageBytes;
  r.full = reinterpret_cast<uint64_t*>(xbuf + p.xbytes + kRedBytes);
  r.empty = r.full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid == 0) {
    sh.xbuf = xbuf;
    sh.red = reinterpret_cast<float*>(xbuf + p.xbytes);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&r.full[s], 1);
      sm90::mbar_init(&r.empty[s], kConsumerWarps);   // lane 0 of each
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    if (tid == kConsumers) produce(p, r);
    return;
  }

  unsigned long long* stamp =
      p.stamps ? p.stamps + (size_t)blockIdx.x * (2 + 2 * kPhases * p.L)
               : nullptr;
  if (stamp && tid == 0) stamp[0] = globaltimer();
  for (int l = 0; l < p.L; ++l) {
    const int at = 2 + 2 * kPhases * l;
    matmul_phase(p, l, 0, r, sh);                          // 1. qkv
    grid_wait(p, stamp, at);
    attention_phase(p, l, r, sh);                          // 2. attention
    grid_wait(p, stamp, at + 2);
    matmul_phase(p, l, 1, r, sh);                          // 3. o
    grid_wait(p, stamp, at + 4);
    matmul_phase(p, l, 2, r, sh);                          // 4. gate/up
    grid_wait(p, stamp, at + 6);
    matmul_phase(p, l, 3, r, sh);                          // 5. down
    if (l + 1 < p.L) {
      grid_wait(p, stamp, at + 8);
    } else if (stamp) {
      consumers_sync();
      if (tid == 0) stamp[at + 8] = stamp[at + 9] = globaltimer();
    }
  }
  if (stamp && tid == 0) stamp[1] = globaltimer();
}

// Dynamic shared memory: alignment slack, the ring, the x tiles (or the
// two groups' attention scratch), the k-step sums, the ring's barriers.
size_t dynamic_smem(int S, int* xbytes) {
  const int attn = (kGroups * attn_scratch(S) + 1023) & ~1023;
  *xbytes = attn > kXBytes ? attn : kXBytes;
  return 1024 + (size_t)kStages * kStageBytes + *xbytes + kRedBytes
         + 2 * kStages * sizeof(uint64_t);
}

}  // namespace

// The TMA maps of the packed weights of L layers: `ptrs` (host, L x 4:
// wqkv, wo, wgu, wdn) -> `out` (host, L x 4 x 128 bytes, to be copied to
// the device), each a 2-d uint8 map of 64-row x 128-column boxes with the
// 128-byte swizzle.  Returns 0, or a CUDA error.
extern "C" int groma_decode_megakernel_maps(void* out,
                                            const unsigned long long* ptrs,
                                            int L, int D, int F) {
  if (sm90::encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  const int rows[kMatrices] = {D / 2, D / 2, D / 2, F / 2};
  const int cols[kMatrices] = {3 * D, D, 2 * F, D};
  for (int i = 0; i < L * kMatrices; ++i) {
    CUtensorMap map;
    const int m = i % kMatrices;
    if (!sm90::make_map_2d(&map, reinterpret_cast<const void*>(ptrs[i]), 1,
                           cols[m], rows[m], kCols, kBox, true))
      return (int)cudaErrorInvalidValue;
    memcpy(static_cast<uint8_t*>(out) + (size_t)i * sizeof(CUtensorMap),
           &map, sizeof(CUtensorMap));
  }
  return 0;
}

// x0/x (B, D) f32; cos/sin (B, 128) f32; mask (B, S) f32; cur (B,) f32;
// ln1/ln2 (L, D) f32; wtab (L, 8) and ctab (L, 4) device tables of the
// per-layer weight and cache addresses (packed (K/2, N) uint8 with
// (K/256, N) f32 scales; (B, H, S, 128) int8 with (B, H, S) f32 scales);
// maps (L, 4) the weights' tensor maps (groma_decode_megakernel_maps);
// plan the segments of `ctas` CTAs (megakernel_plan); qkv (B, 3 D) f32,
// attn (B, D) bf16, act (B, F) bf16 scratch; work, the f32 split-K
// workspace; sync, 2 + (the most tiles of a matrix) uint32 words, zero
// before the first call and left so by every call; stamps null or
// (ctas, 2 + 10 L) uint64; pos, one int32 on the device, the slot of this
// token, 0 <= *pos < S (the caller's to keep: the host never reads it).
// All contiguous; B <= 8, D = 128 H and F multiples of 256.  Returns the
// launch's CUDA status (0 = launched): a grid that cannot be co-resident, or shared memory that
// cannot be had, is refused.  info[0] receives the grid, info[1] the grid
// barriers a step, info[2] the dynamic shared memory in bytes.
extern "C" int groma_decode_megakernel(
    const void* x0, void* x, const void* cos, const void* sin,
    const void* mask, const void* cur, const void* ln1, const void* ln2,
    const void* wtab, const void* maps, const void* ctab, const void* plan,
    void* qkv, void* attn, void* act, void* work, void* sync, void* stamps,
    const void* pos, int L, int B, int H, int S, int F, int ctas, float eps,
    int* info, void* stream) {
  const int D = H * kHD;
  if (L < 1 || B < 1 || B > kMT || H < 1 || S < 1 || pos == nullptr ||
      D % kScaleBlock || F < kScaleBlock || F % kScaleBlock || ctas < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x0 = static_cast<const float*>(x0);
  p.x = static_cast<float*>(x);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.mask = static_cast<const float*>(mask);
  p.cur = static_cast<const float*>(cur);
  p.ln1 = static_cast<const float*>(ln1);
  p.ln2 = static_cast<const float*>(ln2);
  p.wtab = static_cast<const unsigned long long*>(wtab);
  p.maps = static_cast<const CUtensorMap*>(maps);
  p.ctab = static_cast<const unsigned long long*>(ctab);
  p.plan = static_cast<const int*>(plan);
  p.qkv = static_cast<float*>(qkv);
  p.attn = static_cast<bf16*>(attn);
  p.act = static_cast<bf16*>(act);
  p.ssq = static_cast<float*>(work);
  p.part = p.ssq + (size_t)(D / kCols) * kMT;
  p.sync = static_cast<unsigned*>(sync);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.L = L;
  p.B = B;
  p.H = H;
  p.S = S;
  p.F = F;
  p.pos = static_cast<const int*>(pos);
  p.eps = eps;
  p.scale = (float)(1.0 / sqrt((double)kHD));
  const size_t smem = dynamic_smem(S, &p.xbytes);
  cudaError_t e = cudaFuncSetAttribute(
      decode_megakernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;        // the ring cannot be had
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                    decode_megakernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if ((long long)per_sm * sms < ctas)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  info[0] = ctas;
  info[1] = kPhases * L - 1;
  info[2] = (int)smem;
  // cudaLaunchKernelEx with the cooperative attribute: the launch a CUDA
  // graph captures as a cooperative kernel node
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_megakernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
