// Weight-only packed-int4 GEMM for LLaMA decode and prefill on Hopper
// (sm_90a).
//
// Replaces the TPU kernel groma_tpu/ops/quant4.py `_int4_matmul_kernel`
// (entry `int4_matmul`).  Computes out (M, N) bf16 =
//   sum_k x[m, k] * (nibble(k, n) - 8) * scale[k / 256, n]
// with f32 accumulation.  The byte layout is the JAX package's: packed
// (K/2, N) uint8, row k in the low nibble of byte (k, n) and row k + K/2 in
// its high nibble, each stored as q + 8; scale (K/256, N) f32.  K must be a
// multiple of 256 (so K/2 is one of 128) and N of 64.
//
// Two tile shapes in one source, as the TPU kernel computes the product in
// its own body at every M:
//
// * decode (M <= 8, mt = 1, 2, 4 or 8 rows a block): weight-byte bound.
//   Every weight is read once for 2 M flops, 0.5 byte against int8's 1, so
//   a 7B decode step streams ~3.5 GB.  As in int8_matmul.cu, a block owns a
//   strip of 64 columns and its 64 row lanes walk the K/2 packed rows, one
//   16-byte load (16 columns, 32 weights) each; when the strips give too
//   few blocks for the SMs, the packed rows are split over gridDim.z and a
//   second kernel adds the f32 partial sums.  The rows are walked in chunks
//   of 128 packed rows: inside one chunk both halves keep one scale block
//   (K/2 is a multiple of 128), so a thread loads its 32 scales once a
//   chunk.  Nibbles become exact floats through a byte-permute into the
//   mantissa of 2^23 (nibble - 8 after one FADD), then times the scale.
//   down_proj's K = 11008 needs nothing special: its scale block 21
//   (rows 5376..5631) straddles the halves at K/2 = 5504, where the TPU
//   kernel splits it into two dots; here it is the low block of the chunk
//   at packed row 5376 and the high block of the chunk at packed row 0,
//   two whole chunks.
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

#include "decode_common.cuh"
#include "flash_common.cuh"

namespace {

using decode::load16;
using decode::nib4_to_float;
using flash::bf16;

constexpr int kScaleBlock = 256;   // K rows per scale row
constexpr int kChunk = 128;        // packed rows with fixed scale blocks

// ----------------------------------------------------------------- decode

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 64;                         // columns per block
constexpr int kColGroups = kBlockN / 16;            // threads per row piece
constexpr int kRowLanes = kThreads / kColGroups;    // rows per step

template <int MT>
__global__ void __launch_bounds__(kThreads)
int4_decode_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale, bf16* __restrict__ out,
                   float* __restrict__ partial, int M, int K, int N,
                   int p_chunk) {
  __shared__ float red[kWarps][MT][kBlockN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = tid % kColGroups;
  const int row_lane = tid / kColGroups;
  const int col0 = blockIdx.x * kBlockN + cg * 16;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int kh = K / 2;
  const int p_begin = blockIdx.z * p_chunk;
  const int p_end = min(kh, p_begin + p_chunk);
  const bf16* xm = x + (size_t)m0 * K;

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.0f;

  if (col0 < N) {
    for (int c = p_begin; c < p_end; c += kChunk) {
      float s_lo[16], s_hi[16];
      load16(scale + (size_t)(c / kScaleBlock) * N + col0, s_lo);
      load16(scale + (size_t)((c + kh) / kScaleBlock) * N + col0, s_hi);
      const int c_end = min(p_end, c + kChunk);
      for (int r = c + row_lane; r < c_end; r += kRowLanes) {
        const uint4 p = __ldg(reinterpret_cast<const uint4*>(
            w + (size_t)r * N + col0));
        float xl[MT], xh[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          xl[m] = m < rows ? __bfloat162float(xm[(size_t)m * K + r]) : 0.0f;
          xh[m] = m < rows ? __bfloat162float(xm[(size_t)m * K + kh + r])
                           : 0.0f;
        }
        const uint32_t words[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi) {
          float f[4];
          nib4_to_float(words[wi] & 0x0F0F0F0Fu, f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float wv = f[e] * s_lo[4 * wi + e];
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][4 * wi + e] = fmaf(xl[m], wv, acc[m][4 * wi + e]);
          }
          nib4_to_float((words[wi] >> 4) & 0x0F0F0F0Fu, f);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float wv = f[e] * s_hi[4 * wi + e];
#pragma unroll
            for (int m = 0; m < MT; ++m)
              acc[m][4 * wi + e] = fmaf(xh[m], wv, acc[m][4 * wi + e]);
          }
        }
      }
    }
  }

  // lanes sharing a column group differ in bits 2..4 of the lane id
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  if (lane < kColGroups) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[warp][m][cg * 16 + j] = acc[m][j];
  }
  __syncthreads();

  for (int idx = tid; idx < MT * kBlockN; idx += kThreads) {
    const int m = idx / kBlockN;
    const int c = idx % kBlockN;
    const int col = blockIdx.x * kBlockN + c;
    if (m >= rows || col >= N) continue;
    float s = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][m][c];
    if (partial == nullptr) {
      out[(size_t)(m0 + m) * N + col] = __float2bfloat16(s);
    } else {
      partial[((size_t)blockIdx.z * M + m0 + m) * N + col] = s;
    }
  }
}

__global__ void int4_splitk_epilogue(const float* __restrict__ partial,
                                     bf16* __restrict__ out, int M, int N,
                                     int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (idx >= mn) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[z * mn + idx];
  out[idx] = __float2bfloat16(s);
}

template <int MT>
void launch_decode(const void* x, const void* w, const void* scale, void* out,
                   void* partial, int M, int K, int N, int p_chunk,
                   int splits, cudaStream_t stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + MT - 1) / MT, splits);
  int4_decode_kernel<MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<bf16*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, K, N, p_chunk);
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
// all contiguous.  mt = 0 runs the prefill tile; mt = 1, 2, 4 or 8 the
// decode tile, whose `partial` is an f32 (splits, M, N) workspace (unused
// when splits == 1) and p_chunk * splits, a multiple of 128 packed rows,
// must cover K/2.  Returns cudaGetLastError() after the launches.
extern "C" int groma_int4_matmul(const void* x, const void* w,
                                 const void* scale, void* out, void* partial,
                                 int M, int K, int N, int mt, int p_chunk,
                                 int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K % kScaleBlock || N % kBN) return (int)cudaErrorInvalidValue;
  if (mt == 0) {
    const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
    int4_prefill_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(scale), static_cast<bf16*>(out), M, K, N);
    return (int)cudaGetLastError();
  }
  if (p_chunk % kChunk || (size_t)p_chunk * splits < (size_t)(K / 2))
    return (int)cudaErrorInvalidValue;
  switch (mt) {
    case 1: launch_decode<1>(x, w, scale, out, partial, M, K, N, p_chunk, splits, s); break;
    case 2: launch_decode<2>(x, w, scale, out, partial, M, K, N, p_chunk, splits, s); break;
    case 4: launch_decode<4>(x, w, scale, out, partial, M, K, N, p_chunk, splits, s); break;
    case 8: launch_decode<8>(x, w, scale, out, partial, M, K, N, p_chunk, splits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (splits > 1) {
    const size_t mn = (size_t)M * N;
    int4_splitk_epilogue<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(partial), static_cast<bf16*>(out), M, N,
        splits);
  }
  return (int)cudaGetLastError();
}
