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
// The products run on mma.sync m16n8k32 s8 (int32 sums, exact) with xq as
// the A operand, its rows 8..15 zero.  A block of 4 warps owns 64 columns;
// each warp walks chunks of 128 weight rows (packed rows for int4), staged
// in its own shared-memory tile with 16-byte loads, and gathers each B
// fragment's 4 k-consecutive bytes from there.  For int4 one gather gives
// both nibble planes, and a chunk of 128 packed rows lies inside one scale
// block in each plane (K/2 is a multiple of 128), so at down_proj, where
// scale block 21 (rows 5376..5631) straddles K/2 = 5504, the block's two
// halves are two chunks, each scaled on its own, as the TPU kernel splits
// it into two dots.  Weight rows are split over gridDim.y until about two
// blocks run per SM; w8a8 adds int32 partial sums (exact, in any order),
// int4-a8 f32 ones, into a zeroed workspace with atomics, and a last kernel
// applies the scales.  Three launches a call: the activation quantizer
// (one block per row, also the int32 sums of xq over each 128-column
// segment), the product, the epilogue.  What bounds it: the weight bytes
// (K x N, or K/2 x N plus scales), as for #1 and #7.
// Plain versions and wrapper:
// groma_tpu_torch/benchmarks/exp_decode_matmul_m8.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kM = 8;
constexpr int kSeg = 128;             // rows a chunk; xq sums per segment
constexpr int kScaleBlock = 256;      // K rows per int4 scale row
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 64;
constexpr int kPitch = kBlockN + 8;   // bytes: 18 words, no bank conflicts
constexpr int kQuantThreads = 256;

__global__ void __launch_bounds__(kQuantThreads)
act_quant_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                 float* __restrict__ xs, int* __restrict__ xsum, int K) {
  __shared__ float red[kQuantThreads / 32];
  const int m = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bf16* row = x + (size_t)m * K;
  float a = 0.0f;
  for (int k = tid; k < K; k += kQuantThreads)
    a = fmaxf(a, fabsf(__bfloat162float(row[k])));
  a = decode::block_max<kQuantThreads / 32>(a, red);
  const float s = a > 0.0f ? __fdiv_rn(a, 127.0f) : 1.0f;
  for (int k = tid; k < K; k += kQuantThreads) {
    const float q = rintf(__fdiv_rn(__bfloat162float(row[k]), s));
    xq[(size_t)m * K + k] = (int8_t)(int)fminf(fmaxf(q, -127.0f), 127.0f);
  }
  if (tid == 0) xs[m] = s;
  __syncthreads();        // this block's xq writes are visible to it
  for (int seg = warp; seg < K / kSeg; seg += kQuantThreads / 32) {
    const int8_t* sp = xq + (size_t)m * K + seg * kSeg;
    int v = sp[lane] + sp[lane + 32] + sp[lane + 64] + sp[lane + 96];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) xsum[m * (K / kSeg) + seg] = v;
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Bytes of rows r .. r+3 at column c of a staged tile, lowest row lowest.
__device__ __forceinline__ uint32_t gather4(const uint8_t* tile, int r,
                                            int c) {
  const uint8_t* p = tile + r * kPitch + c;
  return (uint32_t)p[0] | ((uint32_t)p[kPitch] << 8)
         | ((uint32_t)p[2 * kPitch] << 16) | ((uint32_t)p[3 * kPitch] << 24);
}

// The A fragment of xq's 8 rows (rows 8..15 zero) at columns k0 .. k0+31.
__device__ __forceinline__ void load_xq(uint32_t* a, const int8_t* xrow,
                                        int k0, int t) {
  a[0] = *reinterpret_cast<const uint32_t*>(xrow + k0 + 4 * t);
  a[1] = 0u;
  a[2] = *reinterpret_cast<const uint32_t*>(xrow + k0 + 16 + 4 * t);
  a[3] = 0u;
}

template <bool INT4>
__global__ void __launch_bounds__(kThreads)
m8_mma_kernel(const int8_t* __restrict__ xq, const int* __restrict__ xsum,
              const uint8_t* __restrict__ w, const float* __restrict__ scale,
              void* __restrict__ ws, int K, int N, int chunks_per_split) {
  __shared__ __align__(16) uint8_t tiles[kWarps][kSeg * kPitch];
  __shared__ float red[kWarps][kM][kBlockN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBlockN;
  const int rows = INT4 ? K / 2 : K;         // weight rows in memory
  const int chunks = rows / kSeg;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int c_end = min(chunks, c_begin + chunks_per_split);
  const int8_t* xrow = xq + (size_t)g * K;
  uint8_t* tile = tiles[warp];

  int iacc[kBlockN / 8][4];       // w8a8: the whole split's int32 sums
  float facc[kBlockN / 8][2];     // int4-a8: scaled sums of the chunks
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) iacc[j][e] = 0;
    facc[j][0] = facc[j][1] = 0.0f;
  }

  for (int ch = c_begin + warp; ch < c_end; ch += kWarps) {
    const int r0 = ch * kSeg;
    __syncwarp();
    for (int idx = lane; idx < kSeg * (kBlockN / 16); idx += 32) {
      const int r = idx / (kBlockN / 16), c = (idx % (kBlockN / 16)) * 16;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          w + (size_t)(r0 + r) * N + n0 + c));
      uint2* dst = reinterpret_cast<uint2*>(tile + r * kPitch + c);
      dst[0] = make_uint2(v.x, v.y);
      dst[1] = make_uint2(v.z, v.w);
    }
    __syncwarp();
    int lo[kBlockN / 8][4], hi[kBlockN / 8][4];
    if (INT4) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) lo[j][e] = hi[j][e] = 0;
    }
#pragma unroll
    for (int kk = 0; kk < kSeg / 32; ++kk) {
      uint32_t alo[4], ahi[4];
      load_xq(alo, xrow, r0 + 32 * kk, t);
      if (INT4) load_xq(ahi, xrow, K / 2 + r0 + 32 * kk, t);
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const int c = 8 * j + g;
        const uint32_t b0 = gather4(tile, 32 * kk + 4 * t, c);
        const uint32_t b1 = gather4(tile, 32 * kk + 16 + 4 * t, c);
        if (INT4) {
          const uint32_t bl[2] = {b0 & 0x0F0F0F0Fu, b1 & 0x0F0F0F0Fu};
          const uint32_t bh[2] = {(b0 >> 4) & 0x0F0F0F0Fu,
                                  (b1 >> 4) & 0x0F0F0F0Fu};
          mma_s8(lo[j], alo, bl);
          mma_s8(hi[j], ahi, bh);
        } else {
          const uint32_t b[2] = {b0, b1};
          mma_s8(iacc[j], alo, b);
        }
      }
    }
    if (INT4) {
      // (dot - 8 sum(xq)) per plane, times its block's scale
      const int nseg = K / kSeg;
      const int sl = xsum[g * nseg + ch];
      const int sh = xsum[g * nseg + (K / 2) / kSeg + ch];
      const float* scl = scale + (size_t)(r0 / kScaleBlock) * N;
      const float* sch = scale + (size_t)((K / 2 + r0) / kScaleBlock) * N;
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * t + e;
          facc[j][e] += (float)(lo[j][e] - 8 * sl) * __ldg(scl + col)
                        + (float)(hi[j][e] - 8 * sh) * __ldg(sch + col);
        }
    }
  }

  // C rows 0..7 (registers 0, 1) are x's rows; 8..15 are zero
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      red[warp][g][8 * j + 2 * t + e] =
          INT4 ? facc[j][e] : __int_as_float(iacc[j][e]);
  __syncthreads();
  for (int idx = tid; idx < kM * kBlockN; idx += kThreads) {
    const int m = idx / kBlockN, c = idx % kBlockN;
    const size_t at = (size_t)m * N + n0 + c;
    if (INT4) {
      float s = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi][m][c];
      atomicAdd(static_cast<float*>(ws) + at, s);
    } else {
      int s = 0;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += __float_as_int(red[wi][m][c]);
      atomicAdd(static_cast<int*>(ws) + at, s);
    }
  }
}

template <bool INT4>
__global__ void m8_epilogue(const void* __restrict__ ws,
                            const float* __restrict__ xs,
                            const float* __restrict__ scale,
                            float* __restrict__ out, int N) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= kM * N) return;
  const int m = idx / N;
  if (INT4)
    out[idx] = static_cast<const float*>(ws)[idx] * xs[m];
  else
    out[idx] = (float)static_cast<const int*>(ws)[idx] * xs[m]
               * scale[idx % N];
}

}  // namespace

// x (8, K) bf16; int4 = 0: w (K, N) int8 and scale (N,) f32; int4 = 1:
// w (K/2, N) uint8 packed as #7 and scale (K/256, N) f32.  Workspaces:
// xq (8, K) int8, xs (8,) f32, xsum (8, K/128) int32, acc (8, N) of 4
// bytes; out (8, N) f32.  All contiguous and 16-byte aligned; K a multiple
// of 256, N of 64; chunks_per_split * splits >= the weight rows / 128.
// Launches the quantizer, the product and the epilogue on `stream`;
// returns cudaGetLastError() (0 = launched).
extern "C" int groma_probe_m8_matmul(const void* x, const void* w,
                                     const void* scale, void* out, void* xq,
                                     void* xs, void* xsum, void* acc, int K,
                                     int N, int int4, int chunks_per_split,
                                     int splits, void* stream) {
  const int rows = int4 ? K / 2 : K;
  if (K < kScaleBlock || K % kScaleBlock || N < kBlockN || N % kBlockN
      || chunks_per_split < 1
      || (size_t)chunks_per_split * splits * kSeg < (size_t)rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * kM * N, s);
  if (err != cudaSuccess) return (int)err;
  act_quant_kernel<<<kM, kQuantThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), static_cast<int*>(xsum), K);
  const dim3 grid(N / kBlockN, splits);
  const int epi_blocks = (kM * N + 255) / 256;
  if (int4) {
    m8_mma_kernel<true><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(xq), static_cast<const int*>(xsum),
        static_cast<const uint8_t*>(w), static_cast<const float*>(scale), acc,
        K, N, chunks_per_split);
    m8_epilogue<true><<<epi_blocks, 256, 0, s>>>(
        acc, static_cast<const float*>(xs), static_cast<const float*>(scale),
        static_cast<float*>(out), N);
  } else {
    m8_mma_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const int8_t*>(xq), static_cast<const int*>(xsum),
        static_cast<const uint8_t*>(w), static_cast<const float*>(scale), acc,
        K, N, chunks_per_split);
    m8_epilogue<false><<<epi_blocks, 256, 0, s>>>(
        acc, static_cast<const float*>(xs), static_cast<const float*>(scale),
        static_cast<float*>(out), N);
  }
  return (int)cudaGetLastError();
}
