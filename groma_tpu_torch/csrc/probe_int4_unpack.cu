// H100 probe of the packed-int4 nibble unpack (sm_90a).
//
// Replaces the TPU probe kernels `_kern_a`, `_kern_b`, `_kern_c` of
// benchmarks/exp_int4_unpack.py, which time one unpack + dot through three
// integer lane widths of the TPU's vector unit.  All three compute
//   out (8, N) f32 = x[:, :KH] @ (p & 0xF) + x[:, KH:] @ (p >> 4)
// from x (8, 2 KH) bf16 and p (KH, N) uint8: unsigned nibbles, no bias, no
// scale, f32 accumulation.  The card's three variants, in place of the
// TPU's lane widths:
//   A  the unpack #7's decode tile ships (int4_matmul.cu): 32-bit words,
//      a byte-permute of each nibble into the mantissa of 2^23, one FADD,
//      then f32 FMAs on the CUDA cores;
//   B  a per-nibble integer shift and mask, then an int-to-float
//      conversion, then the same FMAs;
//   C  nibbles to bf16 pairs with one lop3 on 0x4300 (128 + n, exact for
//      0..15) minus 128, then mma.sync m16n8k16 bf16 with x as the A
//      operand, its rows 8..15 zero: "stay narrow and feed the matrix
//      unit", the question of the TPU's variant C.
// What bounds all three: the packed bytes (KH x N), read once.  A and B
// walk them as #7's decode tile does (a block owns 64 columns, 64 row lanes
// of one 16-byte load each); C stages 64 packed rows x 64 columns in shared
// memory and gathers each B fragment's bytes from there.  The packed rows
// are split over gridDim.y so that about two blocks run per SM; every split
// adds its partial sums into `out` (zeroed first) with f32 atomics, so the
// order of the sums varies from run to run.
// Plain version and wrapper: groma_tpu_torch/benchmarks/exp_int4_unpack.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::bf16;

constexpr int kM = 8;                  // rows of x
constexpr int kBlockN = 64;            // columns a block
constexpr int kRowAlign = 128;         // KH and the split chunks
// A and B
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColGroups = kBlockN / 16;          // 16 columns a thread
constexpr int kRowLanes = kThreads / kColGroups;  // packed rows a step
// C
constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kTileRows = 16 * kMmaWarps;         // 16 packed rows a warp
constexpr int kPitch = kBlockN + 16;              // bytes: 20 words a row

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

template <int V>   // 0: A, 1: B
__global__ void __launch_bounds__(kThreads)
unpack_fma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ p,
                  float* __restrict__ out, int KH, int N, int p_chunk) {
  __shared__ float red[kWarps][kM][kBlockN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % kColGroups, row_lane = tid / kColGroups;
  const int col0 = blockIdx.x * kBlockN + cg * 16;
  const int K = 2 * KH;
  const int p_begin = blockIdx.y * p_chunk;
  const int p_end = min(KH, p_begin + p_chunk);

  float acc[kM][16];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.0f;

  for (int r = p_begin + row_lane; r < p_end; r += kRowLanes) {
    const uint4 pk = __ldg(reinterpret_cast<const uint4*>(
        p + (size_t)r * N + col0));
    float xl[kM], xh[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      xl[m] = __bfloat162float(x[(size_t)m * K + r]);
      xh[m] = __bfloat162float(x[(size_t)m * K + KH + r]);
    }
    const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      float lo[4], hi[4];
      if (V == 0) {
        unpack_prmt(words[wi] & 0x0F0F0F0Fu, lo);
        unpack_prmt((words[wi] >> 4) & 0x0F0F0F0Fu, hi);
      } else {
        unpack_shift(words[wi], 0, lo);
        unpack_shift(words[wi], 4, hi);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          acc[m][4 * wi + e] = fmaf(xl[m], lo[e], acc[m][4 * wi + e]);
          acc[m][4 * wi + e] = fmaf(xh[m], hi[e], acc[m][4 * wi + e]);
        }
    }
  }

  // lanes sharing a column group differ in bits 2..4 of the lane id
#pragma unroll
  for (int m = 0; m < kM; ++m)
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
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[warp][m][cg * 16 + j] = acc[m][j];
  }
  __syncthreads();
  for (int idx = tid; idx < kM * kBlockN; idx += kThreads) {
    const int m = idx / kBlockN, c = idx % kBlockN;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][m][c];
    atomicAdd(out + (size_t)m * N + blockIdx.x * kBlockN + c, s);
  }
}

// Two bytes (low halves of a and b) -> a bf16 pair of their nibbles at
// `shift`: one lop3 puts each nibble under the exponent of 128, and 128 is
// subtracted in bf16 (exact: 128 + n has 7 mantissa bits).
__device__ __forceinline__ uint32_t nibble_pair_bf16(uint32_t a, uint32_t b,
                                                     int shift) {
  const uint32_t w = ((a | (b << 16)) >> shift);
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(r) : "r"(w), "r"(0x000F000Fu), "r"(0x43004300u));
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&r);
  v = __hsub2(v, __floats2bfloat162_rn(128.0f, 128.0f));
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kMmaThreads)
unpack_mma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ p,
                  float* __restrict__ out, int KH, int N, int p_chunk) {
  __shared__ __align__(16) uint8_t tile[kTileRows * kPitch];
  __shared__ float red[kMmaWarps][kM][kBlockN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBlockN;
  const int K = 2 * KH;
  const int p_begin = blockIdx.y * p_chunk;
  const int p_end = min(KH, p_begin + p_chunk);
  const bf16* xg = x + (size_t)g * K;

  float acc[kBlockN / 8][4];
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int r0 = p_begin; r0 < p_end; r0 += kTileRows) {
    __syncthreads();
    for (int idx = tid; idx < kTileRows * (kBlockN / 16); idx += kMmaThreads) {
      const int r = idx / (kBlockN / 16), c = (idx % (kBlockN / 16)) * 16;
      *reinterpret_cast<uint4*>(tile + r * kPitch + c) = __ldg(
          reinterpret_cast<const uint4*>(p + (size_t)(r0 + r) * N + n0 + c));
    }
    __syncthreads();
    // this warp: packed rows r0 + 16 warp .. +15, the k16 step of each plane
    const int kr = 16 * warp;
    const int klo = r0 + kr + 2 * t;
    const uint32_t alo[4] = {flash::ld32(xg + klo), 0u,
                             flash::ld32(xg + klo + 8), 0u};
    const uint32_t ahi[4] = {flash::ld32(xg + KH + klo), 0u,
                             flash::ld32(xg + KH + klo + 8), 0u};
    const uint8_t* tr = tile + (kr + 2 * t) * kPitch;
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      const int c = 8 * j + g;
      const uint32_t v0 = tr[c], v1 = tr[kPitch + c];
      const uint32_t v8 = tr[8 * kPitch + c], v9 = tr[9 * kPitch + c];
      const uint32_t blo[2] = {nibble_pair_bf16(v0, v1, 0),
                               nibble_pair_bf16(v8, v9, 0)};
      const uint32_t bhi[2] = {nibble_pair_bf16(v0, v1, 4),
                               nibble_pair_bf16(v8, v9, 4)};
      flash::mma_bf16(acc[j], alo, blo);
      flash::mma_bf16(acc[j], ahi, bhi);
    }
  }

  // C rows 0..7 (registers 0, 1) are x's rows; 8..15 are zero
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    red[warp][g][8 * j + 2 * t] = acc[j][0];
    red[warp][g][8 * j + 2 * t + 1] = acc[j][1];
  }
  __syncthreads();
  for (int idx = tid; idx < kM * kBlockN; idx += kMmaThreads) {
    const int m = idx / kBlockN, c = idx % kBlockN;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) s += red[w][m][c];
    atomicAdd(out + (size_t)m * N + n0 + c, s);
  }
}

}  // namespace

// x (8, 2 KH) bf16, p (KH, N) uint8, out (8, N) f32, all contiguous and
// 16-byte aligned; KH a multiple of 128, N of 64; variant 0 (A), 1 (B) or
// 2 (C); p_chunk a multiple of 128 with p_chunk * splits >= KH.  Zeroes out,
// then launches one kernel on `stream`.  Returns cudaGetLastError() (0 =
// launched).
extern "C" int groma_probe_int4_unpack(const void* x, const void* p,
                                       void* out, int KH, int N, int variant,
                                       int p_chunk, int splits,
                                       void* stream) {
  if (KH < kRowAlign || KH % kRowAlign || N < kBlockN || N % kBlockN
      || p_chunk % kRowAlign || p_chunk < kRowAlign
      || (size_t)p_chunk * splits < (size_t)KH)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * kM * N, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / kBlockN, splits);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* pp = static_cast<const uint8_t*>(p);
  auto* op = static_cast<float*>(out);
  switch (variant) {
    case 0:
      unpack_fma_kernel<0><<<grid, kThreads, 0, s>>>(xp, pp, op, KH, N,
                                                      p_chunk);
      break;
    case 1:
      unpack_fma_kernel<1><<<grid, kThreads, 0, s>>>(xp, pp, op, KH, N,
                                                      p_chunk);
      break;
    case 2:
      unpack_mma_kernel<<<grid, kMmaThreads, 0, s>>>(xp, pp, op, KH, N,
                                                     p_chunk);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
