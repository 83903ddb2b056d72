// H100 probes of the M=8 decode matmul on the int8 tensor cores (sm_90a).
//
// Replaces the TPU probe kernels `_w8a8_kernel` and `_int4_a8_kernel` of
// benchmarks/exp_decode_matmul_m8.py, which ask whether int8 x int8 dots
// beat weight streaming at M=8.  Both quantize the activations per row
// first (`_act_q`): a = max|x|, s = a / 127 (IEEE, __fdiv_rn; 1 where
// a = 0), xq = clip(rint(x / s), -127, 127) with rint half to even.  Then:
//   w8a8:    out (8, N) f32 = (xq @ wq as int32) * s[m] * sc[n], wq (K, N)
//            int8 with per-column scales sc (N,);
//   int4-a8: out = s[m] * sum over 256-row scale blocks b of
//            (xq[:, b] @ nib[b] - 8 sum(xq[:, b])) * scale[b, n], where
//            nib are the biased nibbles (q + 8, 0..15) of #7's packed
//            (K/2, N) uint8 layout: row k in the low nibble of packed row
//            k, row k + K/2 in the high nibble.
//
// What bounds it: the weight bytes (K N, or K N / 2 plus the scales) at
// 3.35 TB/s; the products, 2 x 8 K N, are a few us of int8 mma.sync.  So
// the bytes stream through an asynchronous ring, as in the decode tiles of
// #1 (int8_matmul.cu) and #7 (int4_matmul.cu), and the int8 tensor cores
// take them as they are, with no conversion to bf16.  A call is two
// launches:
//
// * the quantizer: one CTA of 1024 threads a row of x, each thread holding
//   up to four 16-byte loads of the row in registers across the block's
//   max, then writing its xq bytes and its rows' int32 sums from the same
//   registers (x is read once).  It writes xq in the order the product
//   reads it (`xq_pos`, below), and for int4-a8 one sum of xq per 64-k
//   chunk.
//   It lets the product launch at once (griddepcontrol.launch_dependents);
// * the product, a programmatic dependent launch (cudaLaunchKernelEx with
//   programmatic stream serialization): its producer issues the first
//   stages' weight boxes (and int4 scale rows) before griddepcontrol.wait
//   and their xq boxes (and xq sums) after it, so the ring fills while the
//   quantizer runs (PERF.md §6: the four layer matmuls about 10 % faster
//   than with the product in a plain ordered launch).
//
// The product:
// - a CTA owns 128 weight columns and a range of weight rows in whole
//   stages, planned by the wrapper (`m8_plan`): w8a8 takes #1's split
//   (ops/quant.py `decode_plan(8, K, N, sms)`, 128-row stages), int4-a8
//   #7's (ops/quant4.py `decode_plan(K, N, sms)`, 64 packed rows a stage)
//   with at least two stages a split where K has them;
// - one producer thread keeps a 4-stage mbarrier ring of TMA loads in
//   flight.  A stage is the weight box (128 x 128 int8, 16 KB, or 64 x 128
//   packed, 8 KB; 128-byte swizzled, evict-first) and xq's 8-row x 64-k
//   boxes of the same k range (two for w8a8, at k = r and r + 64; two for
//   int4-a8, at k = r and K/2 + r); for int4-a8 also the two 32-byte rows
//   of xq sums of those chunks and, where a fold ends (below), the scale
//   row of each ending plane.
//   Columns past N read as zeros and are never written.  Nothing else in
//   the main loop touches device memory;
// - four consumer warps, warp w owning the tile's columns 32 w..32 w + 31
//   at every k of every stage.  The products are mma.sync m16n8k32 s8 with
//   the weights as A (16 columns x 32 k) and xq as B (32 k x the 8 batch
//   rows as N): nothing is padded.  An A register holds 4 k of one column,
//   which lie in 4 rows of the (K, N) box: a thread loads the 32-bit words
//   at its columns 4g..4g+3 of 4 rows and transposes the 4 x 4 bytes with 8
//   prmt, one word per column.  A row g is column 4g + j of n-tile j, A row
//   g + 8 column 4g + 2 + j, so one transpose feeds both n-tiles.  The k
//   order inside a k16 group is free as long as A and B share it: product
//   position 4t + i is row 2t + i % 2 + 8 (i / 2) of the group, so the 8
//   lanes of one t read rows whose 16-byte chunks the swizzle puts on 8
//   distinct bank groups (no bank conflicts), and the quantizer stores xq
//   in that order, so each B register is one 32-bit word of xq's box; xq's
//   16-byte groups of row m are also XORed with (m / 2) % 4 in each 64-k
//   box, so the 8 rows' words of one B load lie on distinct banks;
// - int4-a8: after the transpose, v & 0x0F0F0F0F is the low plane (k = r)
//   and (v >> 4) & 0x0F0F0F0F the high plane (k = K/2 + r), each into its
//   own int32 sums against xq at r and at K/2 + r, less 8 times the
//   stage's xq sums.  Integer sums are exact, as on the TPU.  A fold,
//   dot * scale[b, n] in f32 added to the warp's f32 sums, runs once per
//   (plane, 256-row scale block) that a split holds: at the block's end, or
//   at the split's end where a split cuts the block.  A 64-row stage lies
//   in one block of each plane (K/2 is a multiple of 128).  down_proj's
//   block 21 (rows 5376..5631) straddles K/2 = 5504 and is two folds by
//   design, one per plane's sums: one f32 rounding more than the TPU
//   kernel, which adds the two planes' int32 dots and folds it once;
// - the splits: every CTA writes its sums to a workspace (int32 for w8a8,
//   f32 for int4-a8), and the last CTA of a column tile (an arrival
//   counter, which it resets to 0 for the next call) adds the splits in
//   split order and writes the output in the plain version's order of
//   operations: w8a8 float(acc) * s[m] * sc[n], int4-a8 acc * s[m].  No
//   memset, no epilogue launch, no atomics on the sums: two calls give
//   bitwise-equal outputs, and w8a8's equal its plain version's.
// Plain versions, plan and wrapper:
// groma_tpu_torch/benchmarks/exp_decode_matmul_m8.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "decode_common.cuh"
#include "int4_mma.cuh"
#include "sm90_common.cuh"

namespace {

using int4mma::ld_shared32;
using int4mma::swz;

constexpr int kM = 8;                    // rows of x: mma.sync's N
constexpr int kCols = 128;               // weight columns a CTA
constexpr int kScaleBlock = 256;         // K rows per int4 scale row
constexpr int kChunk = 64;               // k of one xq box and one xq sum
constexpr int kXBoxBytes = kM * kChunk;  // 8 rows x 64 bytes
constexpr int kStages = 4;               // depth of the ring
constexpr int kConsumerWarps = 4;        // 32 columns each
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;   // + the producer's warp
constexpr int kQuantThreads = 1024;
constexpr int kQuantVecs = 4;            // 8-value loads a quantizer thread
constexpr int kMaxK = kQuantThreads * kQuantVecs * 8;   // 32768

// A stage: the weight box, xq's two boxes, and for int4-a8 the scale rows
// of the two planes (loaded where a fold ends) and their xq-sum rows.
template <bool INT4>
struct Stage {
  static constexpr int kRows = INT4 ? 64 : 128;        // weight rows
  static constexpr int kOffX = kRows * kCols;
  static constexpr int kOffScale = kOffX + 2 * kXBoxBytes;
  static constexpr int kOffSum = kOffScale + 2 * kCols * 4;
  static constexpr int kBytes =
      INT4 ? (kOffSum + 2 * kM * 4 + 1023) / 1024 * 1024 : kOffScale;
  static_assert(kBytes % 1024 == 0, "swizzled boxes are 1024-aligned");
  // dynamic shared memory: alignment slack, the ring, its barriers
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kBytes + 2 * kStages * sizeof(uint64_t);
};

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Byte offset of xq[m, k] in its row: the 64-k chunk of k, its 16-k group
// XORed with (m / 2) % 4, and inside the group the product's position of
// k (position 4t + i holds k 2t + i % 2 + 8 (i / 2)).
__device__ __forceinline__ int xq_pos(int m, int k) {
  const int u = k & 15;
  const int p = (((u & 7) >> 1) << 2) | (u & 1) | ((u >> 3) << 1);
  return (k & ~63) | ((((k >> 4) & 3) ^ ((m >> 1) & 3)) << 4) | p;
}

// One CTA a row m of x (8, K) bf16: xs[m], xq's row in `xq_pos` order and,
// where xsum is given, the int32 sum of xq's 64-k chunk c at
// xsum[c * 8 + m].
__global__ void __launch_bounds__(kQuantThreads)
m8_quant_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                float* __restrict__ xs, int* __restrict__ xsum, int K) {
  launch_dependents();
  __shared__ float red[kQuantThreads / 32];
  const int m = blockIdx.x, tid = threadIdx.x;
  const int nvec = K / 8;
  const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)m * K);
  uint4 v[kQuantVecs];
  float a = 0.0f;
#pragma unroll
  for (int i = 0; i < kQuantVecs; ++i) {
    const int vi = tid + i * kQuantThreads;
    v[i] = vi < nvec ? __ldg(row + vi) : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a = fmaxf(a, fmaxf(fabsf(__uint_as_float(w[e] << 16)),
                         fabsf(__uint_as_float(w[e] & 0xFFFF0000u))));
  }
  a = decode::block_max<kQuantThreads / 32>(a, red);
  const float s = a > 0.0f ? __fdiv_rn(a, 127.0f) : 1.0f;
  int8_t* qrow = xq + (size_t)m * K;
#pragma unroll
  for (int i = 0; i < kQuantVecs; ++i) {
    const int vi = tid + i * kQuantThreads;
    int sum = 0;
    if (vi < nvec) {
      const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = __uint_as_float(
            e & 1 ? w[e >> 1] & 0xFFFF0000u : w[e >> 1] << 16);
        const int q = (int)fminf(fmaxf(rintf(__fdiv_rn(f, s)), -127.0f),
                                 127.0f);
        qrow[xq_pos(m, 8 * vi + e)] = (int8_t)q;
        sum += q;
      }
    }
    // the 8 lanes 8j..8j+7 hold one 64-k chunk (nvec is a multiple of 8)
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    if (xsum != nullptr && (tid & 7) == 0 && vi < nvec)
      xsum[(vi >> 3) * kM + m] = sum;
  }
  if (tid == 0) xs[m] = s;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The weight bytes of one k32 step (rows r0..r0+31 of the box) at the
// warp's columns c0 + 4g..+3: v[h][j] holds column c0 + 4g + j at the
// product's 4 k of A's k half h (h = 1: rows + 16) for thread t, byte i at
// row 2t + i % 2 + 8 (i / 2): four 32-bit loads and a 4 x 4 byte
// transpose (8 prmt) per half.
__device__ __forceinline__ void load_a(uint32_t (*v)[4], const uint8_t* box,
                                       int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = ld_shared32(box + swz(r0 + 16 * h + 2 * t + (i & 1)
                                       + 8 * (i >> 1), c0 + 4 * g));
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
    v[h][0] = __byte_perm(t0, t2, 0x5410);
    v[h][1] = __byte_perm(t0, t2, 0x7632);
    v[h][2] = __byte_perm(t1, t3, 0x5410);
    v[h][3] = __byte_perm(t1, t3, 0x7632);
  }
}

// The B fragment of xq's k16 groups q and q + 1 of one 8 x 64 box (in
// `xq_pos` order): batch row g, product positions 4t..4t+3 of each group.
__device__ __forceinline__ void load_b(uint32_t* b, const uint8_t* xbox,
                                       int q) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int sw = (g >> 1) & 3;
  b[0] = ld_shared32(xbox + 64 * g + 16 * (q ^ sw) + 4 * t);
  b[1] = ld_shared32(xbox + 64 * g + 16 * ((q + 1) ^ sw) + 4 * t);
}

// n-tile j's A fragment from `load_a` words, after `mask` and `shift`.
__device__ __forceinline__ void a_frag(uint32_t* a, uint32_t (*v)[4], int j,
                                       int shift, uint32_t mask) {
  a[0] = (v[0][j] >> shift) & mask;       // rows g (column 4g + j), k 4t..
  a[1] = (v[0][2 + j] >> shift) & mask;   // rows g + 8 (column 4g + 2 + j)
  a[2] = (v[1][j] >> shift) & mask;       // rows g, k 16 + 4t..
  a[3] = (v[1][2 + j] >> shift) & mask;
}

// Thread (g, t) holds rows m = 2t + e, columns c0 + 4g + {j, 2 + j} of
// n-tile j in part[j][e] and part[j][2 + e].
// The nibbles' bias: part -= 8 xsum[m], xsum one 64-k chunk's sums of xq.
__device__ __forceinline__ void unbias(int (*part)[4], const int* sums) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int x8 = 8 * sums[2 * t + e];
#pragma unroll
    for (int j = 0; j < 2; ++j) part[j][e] -= x8, part[j][2 + e] -= x8;
  }
}

// An int4-a8 fold: acc += f32(part) * scale[col], part = 0.
__device__ __forceinline__ void fold(float (*acc)[4], int (*part)[4],
                                     const float* srow, int c0) {
  const int g = (threadIdx.x & 31) >> 2;
  const float4 s4 = *reinterpret_cast<const float4*>(srow + c0 + 4 * g);
  const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[j][e] = __fadd_rn(acc[j][e], __fmul_rn((float)part[j][e], sc[j]));
      acc[j][2 + e] = __fadd_rn(acc[j][2 + e],
                                __fmul_rn((float)part[j][2 + e], sc[2 + j]));
      part[j][e] = part[j][2 + e] = 0;
    }
  }
}

// The 4 columns c0 + 4g.. of row 2t + e of a thread's sums, in column
// order, as one 16-byte word.
template <typename T>
__device__ __forceinline__ uint4 row4(T (*acc)[4], int e) {
  const T v[4] = {acc[0][e], acc[1][e], acc[0][2 + e], acc[1][2 + e]};
  uint32_t u[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) memcpy(&u[c], &v[c], 4);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t u) {
  T v;
  memcpy(&v, &u, 4);
  return v;
}

template <bool INT4>
__global__ void __launch_bounds__(kThreads, 2)
m8_product_kernel(const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_s,
                  const float* __restrict__ sc, const int* __restrict__ xsum,
                  const float* __restrict__ xs, float* __restrict__ out,
                  void* __restrict__ partial, int* __restrict__ counters,
                  int K, int N, int split_rows) {
  using S = Stage<INT4>;
  using Acc = typename std::conditional<INT4, float, int>::type;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  uint8_t* ring =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * S::kBytes);
  uint64_t* empty = full + kStages;

  const int kh = K / 2;
  const int rows = INT4 ? kh : K;           // weight rows in memory
  const int col0 = blockIdx.x * kCols;
  const int split = blockIdx.y, splits = gridDim.y;
  const int r_begin = split * split_rows;
  const int ntiles = min(split_rows, rows - r_begin) / S::kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);   // lane 0 of each
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // the planes whose fold ends with stage i (int4-a8)
  auto folds = [&](int i, bool& lo, bool& hi) {
    const int r = r_begin + i * S::kRows;
    const bool last = i + 1 == ntiles;
    lo = last || (r + S::kRows) % kScaleBlock == 0;
    hi = last || (kh + r + S::kRows) % kScaleBlock == 0;
  };

  if (warp == kConsumerWarps) {
    // --------------------------------------------------------- producer
    if (lane == 0) {
      sm90::prefetch_map(&tm_w);
      sm90::prefetch_map(&tm_x);
      if (INT4) sm90::prefetch_map(&tm_s);
      const uint64_t evict_first = sm90::evict_first_policy();
      // what does not depend on the quantizer: the weight box, the scales
      auto weights = [&](int i) {
        const int s = i % kStages, r = r_begin + i * S::kRows;
        uint8_t* st = ring + s * S::kBytes;
        bool lo = false, hi = false;
        if (INT4) folds(i, lo, hi);
        sm90::mbar_arrive_expect_tx(
            &full[s], S::kOffScale
                          + (INT4 ? 2 * kM * (int)sizeof(int) : 0)
                          + (lo + hi) * kCols * 4);
        sm90::tma_load_2d_hint(st, &tm_w, &full[s], col0, r, evict_first);
        if (lo)
          sm90::tma_load_2d(st + S::kOffScale, &tm_s, &full[s], col0,
                            r / kScaleBlock);
        if (hi)
          sm90::tma_load_2d(st + S::kOffScale + kCols * 4, &tm_s, &full[s],
                            col0, (kh + r) / kScaleBlock);
      };
      // what the quantizer writes: xq's boxes, the xq sums
      auto activations = [&](int i) {
        const int s = i % kStages, r = r_begin + i * S::kRows;
        uint8_t* st = ring + s * S::kBytes;
        const int r2 = INT4 ? kh + r : r + kChunk;
        sm90::tma_load_2d(st + S::kOffX, &tm_x, &full[s], r, 0);
        sm90::tma_load_2d(st + S::kOffX + kXBoxBytes, &tm_x, &full[s], r2, 0);
        if (INT4) {
          sm90::bulk_load(st + S::kOffSum, xsum + (r / kChunk) * kM,
                          kM * sizeof(int), &full[s]);
          sm90::bulk_load(st + S::kOffSum + kM * sizeof(int),
                          xsum + (r2 / kChunk) * kM, kM * sizeof(int),
                          &full[s]);
        }
      };
      const int pre = min(ntiles, kStages);   // the ring starts empty
      for (int i = 0; i < pre; ++i) weights(i);
      grid_dependency_wait();
      for (int i = 0; i < pre; ++i) activations(i);
      for (int i = pre; i < ntiles; ++i) {
        sm90::mbar_wait(&empty[i % kStages], ((i / kStages) & 1) ^ 1);
        weights(i);
        activations(i);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  grid_dependency_wait();                  // xs, written by the quantizer
  const int g = lane >> 2, t = lane & 3;
  const int c0 = 32 * warp;                // the warp's columns in the tile
  int part[2][2][4];                       // [plane][n-tile][c] int32 sums
  float facc[2][4];                        // int4-a8: the folded sums
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[0][j][e] = part[1][j][e] = 0, facc[j][e] = 0.0f;

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages;
    const uint8_t* st = ring + s * S::kBytes;
    sm90::mbar_wait(&full[s], (i / kStages) & 1);
#pragma unroll
    for (int q = 0; q < S::kRows / 32; ++q) {
      uint32_t v[2][4], a[4];
      load_a(v, st, 32 * q, c0);
      if (INT4) {
        uint32_t b_lo[2], b_hi[2];
        load_b(b_lo, st + S::kOffX, 2 * q);
        load_b(b_hi, st + S::kOffX + kXBoxBytes, 2 * q);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a_frag(a, v, j, 0, 0x0F0F0F0Fu);
          mma_s8(part[0][j], a, b_lo);
          a_frag(a, v, j, 4, 0x0F0F0F0Fu);
          mma_s8(part[1][j], a, b_hi);
        }
      } else {
        uint32_t b[2];
        load_b(b, st + S::kOffX + (q >> 1) * kXBoxBytes, 2 * (q & 1));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a_frag(a, v, j, 0, 0xFFFFFFFFu);
          mma_s8(part[0][j], a, b);
        }
      }
    }
    if (INT4) {
      bool lo, hi;
      folds(i, lo, hi);
      const int* sums = reinterpret_cast<const int*>(st + S::kOffSum);
      const float* srow = reinterpret_cast<const float*>(st + S::kOffScale);
      unbias(part[0], sums);
      unbias(part[1], sums + kM);
      if (lo) fold(facc, part[0], srow, c0);
      if (hi) fold(facc, part[1], srow + kCols, c0);
    }
    // the stage's reads before its TMA refill
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  // this thread's sums: rows 2t + e, columns col0 + c0 + 4g..+3
  const int col = col0 + c0 + 4 * g;
  uint4 mine[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if constexpr (INT4)
      mine[e] = row4(facc, e);
    else
      mine[e] = row4(part[0], e);
  }
  // the output in the plain version's order of operations
  auto write_out = [&](const uint4* v) {
    float sv[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    if constexpr (!INT4) {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(sc + col));
      sv[0] = s4.x, sv[1] = s4.y, sv[2] = s4.z, sv[3] = s4.w;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 2 * t + e;
      const float s = xs[m];
      const uint32_t u[4] = {v[e].x, v[e].y, v[e].z, v[e].w};
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if constexpr (INT4)
          o[c] = __fmul_rn(__uint_as_float(u[c]), s);
        else
          o[c] = __fmul_rn(__fmul_rn(__int2float_rn((int)u[c]), s), sv[c]);
      }
      *reinterpret_cast<float4*>(out + (size_t)m * N + col) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  };
  if (splits == 1) {
    if (col < N) write_out(mine);
    return;
  }

  // split K: every CTA's sums to the workspace; the last CTA of the column
  // tile adds the splits in order
  uint32_t* ws = static_cast<uint32_t*>(partial);
  if (col < N) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<uint4*>(ws + ((size_t)split * kM + 2 * t + e) * N
                                + col) = mine[e];
  }
  __threadfence();
  sm90::named_sync(1, kConsumers);
  if (tid == 0) s_last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  sm90::named_sync(1, kConsumers);
  if (!s_last) return;
  __threadfence();
  if (col < N) {
    Acc sum[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[e][c] = 0;
    for (int z = 0; z < splits; ++z) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint4 p = __ldcg(reinterpret_cast<const uint4*>(
            ws + ((size_t)z * kM + 2 * t + e) * N + col));
        sum[e][0] += from_bits<Acc>(p.x);
        sum[e][1] += from_bits<Acc>(p.y);
        sum[e][2] += from_bits<Acc>(p.z);
        sum[e][3] += from_bits<Acc>(p.w);
      }
    }
    uint4 tot[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      uint32_t u[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) memcpy(&u[c], &sum[e][c], 4);
      tot[e] = make_uint4(u[0], u[1], u[2], u[3]);
    }
    write_out(tot);
  }
  if (tid == 0) counters[blockIdx.x] = 0;     // ready for the next call
}

template <bool INT4>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* xq, void* xs, void* xsum, void* partial, void* counters,
           int K, int N, int split_rows, int splits, cudaStream_t stream) {
  using S = Stage<INT4>;
  const int rows = INT4 ? K / 2 : K;
  if (split_rows <= 0 || split_rows % S::kRows || splits < 1
      || (long long)split_rows * splits < rows
      || (long long)split_rows * (splits - 1) >= rows
      || (INT4 && xsum == nullptr)
      || (splits > 1 && (partial == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      m8_product_kernel<INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::kSmem);
  if (err != cudaSuccess) return (int)err;     // the ring cannot be had
  if (sm90::encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tw, tx;
  if (!sm90::make_map_2d(&tw, w, 1, N, rows, kCols, S::kRows, true)
      || !sm90::make_map_2d(&tx, xq, 1, K, kM, kChunk, kM, false))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ts = tx;                         // w8a8 reads no scale rows
  if (INT4 && !sm90::make_map_2d(&ts, scale, 4, N, K / kScaleBlock, kCols, 1,
                                 false))
    return (int)cudaErrorInvalidValue;
  m8_quant_kernel<<<kM, kQuantThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), INT4 ? static_cast<int*>(xsum) : nullptr, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the product as a programmatic dependent launch of the quantizer
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kCols - 1) / kCols, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* scp = static_cast<const float*>(scale);
  const int* sump = static_cast<const int*>(xsum);
  const float* xsp = static_cast<const float*>(xs);
  float* outp = static_cast<float*>(out);
  int* cntp = static_cast<int*>(counters);
  void* args[] = {&tw, &tx, &ts, &scp, &sump, &xsp, &outp, &partial, &cntp,
                  &K, &N, &split_rows};
  err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(m8_product_kernel<INT4>), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x (8, K) bf16; int4 = 0: w (K, N) int8 and scale (N,) f32; int4 = 1:
// w (K/2, N) uint8 packed as #7 and scale (K/256, N) f32.  Workspaces: xq
// (8, K) int8, xs (8,) f32, for int4 = 1 xsum (K/64, 8) int32, and with
// splits > 1 `partial` (splits, 8, N) of 4-byte sums and `counters` one
// int32 a 128-column tile, zero before the call and left at zero by it;
// out (8, N) f32.  All contiguous and 16-byte aligned; K a multiple of
// 256 up to 32768, N of 16.  The weight rows (packed rows for int4) are
// cut into `splits` ranges of `split_rows` (whole stages of 128, or 64
// packed, rows; the last range shorter and not empty).  Launches the
// quantizer and the product on `stream`; returns cudaGetLastError()
// (0 = launched).
extern "C" int groma_probe_m8_matmul(const void* x, const void* w,
                                     const void* scale, void* out, void* xq,
                                     void* xs, void* xsum, void* partial,
                                     void* counters, int K, int N, int int4,
                                     int split_rows, int splits,
                                     void* stream) {
  if (K < kScaleBlock || K % kScaleBlock || K > kMaxK || N < 16 || N % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int4)
    return launch<true>(x, w, scale, out, xq, xs, xsum, partial, counters, K,
                        N, split_rows, splits, s);
  return launch<false>(x, w, scale, out, xq, xs, xsum, partial, counters, K,
                       N, split_rows, splits, s);
}
