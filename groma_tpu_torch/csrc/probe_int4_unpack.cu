// H100 probe of the packed-int4 nibble unpack (sm_90a).
//
// Replaces the TPU probe kernels `_kern_a`, `_kern_b`, `_kern_c` of
// benchmarks/exp_int4_unpack.py, which time one unpack + dot through three
// integer lane widths of the TPU's vector unit.  All three compute
//   out (8, N) f32 = x[:, :KH] @ (p & 0xF) + x[:, KH:] @ (p >> 4)
// from x (8, 2 KH) bf16 and p (KH, N) uint8: unsigned nibbles, no offset,
// no scale, f32 accumulation.
//
// What bounds it: the packed bytes, KH x N, read once (down_proj, KH =
// 5504, N = 4096: 22.5 MB, 6.7 us at 3.35 TB/s); the products, 32 KH N,
// are a few us of CUDA-core FMAs and far less on the tensor cores.  So the
// bytes stream through an asynchronous ring and only the consumers differ,
// and each variant's time is that of its body, not of its loads:
// - the feed is the int4 decode tile's (int4_matmul.cu): a CTA owns 128
//   columns and a range of packed rows in whole 64-row tiles, planned by the
//   wrapper with ops/quant4.py `decode_plan(2 KH, N, sms)` (at down_proj 32
//   column tiles x 8 splits, the plan #7 runs), at least two tiles a split
//   (at the probe's 1 MB strip, 16 splits of two, not 32 of one);
// - one producer thread keeps a kStages-deep mbarrier ring of TMA loads in
//   flight: a stage is the packed box (64 rows x 128 columns, 8 KB,
//   128-byte swizzled, from a 2-d map of p) and x's two 8-row x 64-k boxes
//   at k = r and KH + r (swizzled), 10 KB; 4 stages, two CTAs per SM: 80 KB
//   in flight per SM.  Columns past N read as zeros and are never written;
// - eight consumer warps read only shared memory.  A stage read with
//   ld.shared is released only after fence.proxy.async, so that its TMA
//   refill cannot overtake the reads;
// - the splits are summed as #7 sums them: every CTA writes its f32 sums to
//   a workspace, and the last CTA of a column tile (a per-tile arrival
//   counter, reset by that CTA for the next call) adds the splits in split
//   order.  One launch a call, and two calls give bitwise-equal outputs.
// The consumers, one per variant:
//   A  byte-permute of each nibble into the mantissa of 2^23, one FADD,
//      then f32 FMAs on the CUDA cores;
//   B  a per-nibble shift and mask, an int-to-float conversion, then the
//      same FMAs;
//   A and B: warp w takes rows 8 w .. 8 w + 7 of each tile, two at a time,
//   lane l its columns 4 l .. 4 l + 3 (32 f32 sums a thread); x's bf16
//   pairs come from the stage as 32-bit broadcast loads;
//   C  lop3 to bf16 pairs (128 + n, exact) minus 128 with one bf16x2 FMA,
//      then mma.sync m16n8k16 with the weights as A (16 columns x 16 k) and
//      x as B (the batch of 8 as N): int4_mma.cuh's fragment mapping and
//      loads, without its q + 8 offset and its scale fold, so nothing is
//      padded.  Warp w runs k16 step w % 4 of every tile on the 64-column
//      group w / 4, both nibble halves into one f32 sum.
// Plain version, plan and wrapper:
// groma_tpu_torch/benchmarks/exp_int4_unpack.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "int4_mma.cuh"
#include "sm90_common.cuh"

namespace {

using int4mma::kBatch;
using int4mma::kTileBytes;
using int4mma::kTileCols;
using int4mma::kTileRows;
using int4mma::kXTileBytes;
using int4mma::ld_shared32;
using int4mma::swz;

constexpr int kStages = 4;                     // depth of the ring
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;      // + the producer's warp
// a stage: the packed tile, then x's tiles at k = r and KH + r
constexpr int kOffX = kTileBytes;
constexpr int kStageBytes = kOffX + 2 * kXTileBytes;        // 10 KB
static_assert(kStageBytes % 1024 == 0, "swizzled tiles are 1024-aligned");
// dynamic shared memory: alignment slack, the ring, its barriers
constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes
                         + 2 * kStages * sizeof(uint64_t);
// after the last tile the ring holds the warps' sums: A and B
// red[warp][m][128], C red[warp][m][64]
static_assert(kConsumerWarps * kBatch * kTileCols * 4
              <= kStages * kStageBytes, "the sums fit the ring");

// 4 nibbles, one in the low bits of each byte of w -> 4 exact floats.
__device__ __forceinline__ void unpack_prmt(uint32_t w, float* f) {
  f[0] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440)) - 8388608.0f;
  f[1] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7441)) - 8388608.0f;
  f[2] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7442)) - 8388608.0f;
  f[3] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7443)) - 8388608.0f;
}

// Nibble e of the low (shift 0) or high (shift 4) half of each byte.
__device__ __forceinline__ void unpack_shift(uint32_t w, int shift, float* f) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __int2float_rn((int)((w >> (8 * e + shift)) & 0xFu));
}

// Variant A (V = 0) or B (V = 1) on one stage: this warp's rows
// 8 w .. 8 w + 7 of the tile, two at a time, this lane's columns
// 4 l .. 4 l + 3 (a warp reads whole 128-byte rows); acc[m][c].
template <int V>
__device__ __forceinline__ void fma_stage(const uint8_t* st, int w, int l,
                                          float (*acc)[4]) {
  const uint8_t* xlo = st + kOffX;
  const uint8_t* xhi = xlo + kXTileBytes;
#pragma unroll
  for (int pr = 0; pr < 4; ++pr) {
    const int r = 8 * w + 2 * pr;                // rows r, r + 1
    const uint32_t a = ld_shared32(st + swz(r, 4 * l));
    const uint32_t b = ld_shared32(st + swz(r + 1, 4 * l));
    float lo0[4], hi0[4], lo1[4], hi1[4];
    if (V == 0) {
      unpack_prmt(a & 0x0F0F0F0Fu, lo0);
      unpack_prmt((a >> 4) & 0x0F0F0F0Fu, hi0);
      unpack_prmt(b & 0x0F0F0F0Fu, lo1);
      unpack_prmt((b >> 4) & 0x0F0F0F0Fu, hi1);
    } else {
      unpack_shift(a, 0, lo0);
      unpack_shift(a, 4, hi0);
      unpack_shift(b, 0, lo1);
      unpack_shift(b, 4, hi1);
    }
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      // x[m, k] and x[m, k + 1] of both halves: one bf16 pair each, the
      // same address across the warp
      const uint32_t pl = ld_shared32(xlo + swz(m, 2 * r));
      const uint32_t ph = ld_shared32(xhi + swz(m, 2 * r));
      const float xl0 = __uint_as_float(pl << 16);
      const float xl1 = __uint_as_float(pl & 0xFFFF0000u);
      const float xh0 = __uint_as_float(ph << 16);
      const float xh1 = __uint_as_float(ph & 0xFFFF0000u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = acc[m][e];
        s = fmaf(xl0, lo0[e], s);
        s = fmaf(xh0, hi0[e], s);
        s = fmaf(xl1, lo1[e], s);
        s = fmaf(xh1, hi1[e], s);
        acc[m][e] = s;
      }
    }
  }
}

// bf16 pair (128 + n0, 128 + n1) -> (n0, n1), exact.
__device__ __forceinline__ uint32_t minus128(uint32_t v) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(0xC300C300u));
  return d;
}

// Variant C on one stage: the warp's k16 step r0 .. r0 + 15 on the 64
// columns c0 .. c0 + 63, int4_mma.cuh's `step` with unsigned nibbles and
// both halves into acc[j] (n-tile j).
__device__ __forceinline__ void mma_stage(const uint8_t* st, int r0, int c0,
                                          float (*acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t b_lo[2], b_hi[2];
  int4mma::load_b(b_lo, st + kOffX, r0);
  int4mma::load_b(b_hi, st + kOffX + kXTileBytes, r0);
  uint32_t w[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 2 * t + (i & 1) + 8 * (i >> 1);
      w[h][i] = ld_shared32(st + swz(row, c0 + 32 * h + 4 * g));
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
    const uint32_t p[4] = {__byte_perm(w[0][0], w[0][1], sel),
                           __byte_perm(w[1][0], w[1][1], sel),
                           __byte_perm(w[0][2], w[0][3], sel),
                           __byte_perm(w[1][2], w[1][3], sel)};
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = minus128(int4mma::low_nibbles(p[i]));
    flash::mma_bf16(acc[j], a, b_lo);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = minus128(int4mma::high_nibbles(p[i]));
    flash::mma_bf16(acc[j], a, b_hi);
  }
}

template <int V>   // 0: A, 1: B, 2: C
__global__ void __launch_bounds__(kThreads, 2)
unpack_kernel(const __grid_constant__ CUtensorMap tm_p,
              const __grid_constant__ CUtensorMap tm_x,
              float* __restrict__ out, float* __restrict__ partial,
              int* __restrict__ counters, int KH, int N, int split_rows) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  uint8_t* ring =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int col0 = blockIdx.x * kTileCols;
  const int split = blockIdx.y, splits = gridDim.y;
  const int p_begin = split * split_rows;
  const int ntiles = min(split_rows, KH - p_begin) / kTileRows;
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
      sm90::prefetch_map(&tm_p);
      sm90::prefetch_map(&tm_x);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages, r = p_begin + i * kTileRows;
        uint8_t* st = ring + s * kStageBytes;
        sm90::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);
        sm90::tma_load_2d(st, &tm_p, &full[s], col0, r);
        sm90::tma_load_3d(st + kOffX, &tm_x, &full[s], r, 0, 0);
        sm90::tma_load_3d(st + kOffX + kXTileBytes, &tm_x, &full[s], KH + r,
                          0, 0);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  float* red = reinterpret_cast<float*>(ring);
  if (V < 2) {
    float acc[kBatch][4];
#pragma unroll
    for (int m = 0; m < kBatch; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages;
      sm90::mbar_wait(&full[s], (i / kStages) & 1);
      fma_stage<V>(ring + s * kStageBytes, warp, lane, acc);
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
    // the warps' rows through the ring
    sm90::named_sync(1, kConsumers);
#pragma unroll
    for (int m = 0; m < kBatch; ++m)
      *reinterpret_cast<float4*>(red + (warp * kBatch + m) * kTileCols
                                 + 4 * lane) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int ks = warp & 3, c0 = (warp >> 2) * 64;   // k16 step, columns
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages;
      sm90::mbar_wait(&full[s], (i / kStages) & 1);
      mma_stage(ring + s * kStageBytes, 16 * ks, c0, acc);
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
    // C (column 4g + j at batch rows 2t, 2t + 1; c2, c3 column 32 + 4g + j)
    // -> red[warp][m][64]
    sm90::named_sync(1, kConsumers);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 2 * t + (e & 1);
      *reinterpret_cast<float4*>(red + (warp * kBatch + m) * 64
                                 + 32 * (e >> 1) + 4 * g) =
          make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
    }
  }
  sm90::named_sync(1, kConsumers);

  // the warps' sums in a fixed order
  for (int o = tid; o < kBatch * kTileCols; o += kConsumers) {
    const int m = o / kTileCols, c = o % kTileCols;
    const int col = col0 + c;
    if (col >= N) continue;
    float sum = 0.0f;
    if (V < 2) {
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w)
        sum += red[(w * kBatch + m) * kTileCols + c];
    } else {
      // warps 4 (c / 64) .. + 3 hold column c % 64 of their group
      const float* v = red + ((c / 64) * 4 * kBatch + m) * 64 + c % 64;
      sum = ((v[0] + v[kBatch * 64]) + v[2 * kBatch * 64])
            + v[3 * kBatch * 64];
    }
    if (splits == 1)
      out[(size_t)m * N + col] = sum;
    else
      partial[((size_t)split * kBatch + m) * N + col] = sum;
  }
  if (splits == 1) return;

  // split K: the last CTA of the column tile adds the splits in order
  __threadfence();
  sm90::named_sync(1, kConsumers);
  if (tid == 0)
    s_last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  sm90::named_sync(1, kConsumers);
  if (!s_last) return;
  __threadfence();
  for (int o = tid; o < kBatch * kTileCols; o += kConsumers) {
    const int m = o / kTileCols, col = col0 + o % kTileCols;
    if (col >= N) continue;
    float sum = 0.0f;
#pragma unroll 8
    for (int z = 0; z < splits; ++z)
      sum += __ldcg(partial + ((size_t)z * kBatch + m) * N + col);
    out[(size_t)m * N + col] = sum;
  }
  if (tid == 0) counters[blockIdx.x] = 0;     // ready for the next call
}

template <int V>
int launch(const CUtensorMap& tp, const CUtensorMap& tx, float* out,
           float* partial, int* counters, int KH, int N, int split_rows,
           int splits, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      unpack_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTileCols - 1) / kTileCols, splits);
  unpack_kernel<V><<<grid, kThreads, kSmem, s>>>(tp, tx, out, partial,
                                                 counters, KH, N, split_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// x (8, 2 KH) bf16, p (KH, N) uint8, out (8, N) f32, all contiguous and
// 16-byte aligned; KH a multiple of 64, N of 64; variant 0 (A), 1 (B) or
// 2 (C).  The packed rows are cut into `splits` ranges of `split_rows`
// (whole 64-row tiles, the last one shorter and not empty); with splits,
// `partial` is an f32 workspace (splits, 8, N) and `counters` one int32 a
// column tile, zero before the call and left at zero by it.  Launches one
// kernel on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int groma_probe_int4_unpack(const void* x, const void* p,
                                       void* out, void* partial,
                                       void* counters, int KH, int N,
                                       int variant, int split_rows,
                                       int splits, void* stream) {
  if (KH < kTileRows || KH % kTileRows || N < 64 || N % 64
      || split_rows <= 0 || split_rows % kTileRows || splits < 1
      || (long long)split_rows * splits < KH
      || (long long)split_rows * (splits - 1) >= KH
      || (splits > 1 && (partial == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (sm90::encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tp, tx;
  if (!sm90::make_map_2d(&tp, p, 1, N, KH, kTileCols, kTileRows, true)
      || !sm90::make_map(&tx, x, 2 * KH, kBatch, 1, kBatch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(partial);
  auto* cp = static_cast<int*>(counters);
  switch (variant) {
    case 0: return launch<0>(tp, tx, op, pp, cp, KH, N, split_rows, splits, s);
    case 1: return launch<1>(tp, tx, op, pp, cp, KH, N, split_rows, splits, s);
    case 2: return launch<2>(tp, tx, op, pp, cp, KH, N, split_rows, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
