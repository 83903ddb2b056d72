// Weight-only int8 skinny GEMM for LLaMA decode on Hopper (sm_90a).
//
// Replaces the TPU kernel groma_tpu/ops/quant.py `_int8_matmul_kernel`
// (entry `int8_matmul`).  Computes out (M, N) bf16 = (x (M, K) bf16 @
// w (K, N) int8) * scale (N,) f32: the int8 weights are converted to f32 in
// registers, the dot accumulates in f32, and the per-column scale is applied
// in the epilogue, after the dot, as the TPU kernel does.
//
// What bounds it: weight bytes.  At decode M = batch (1..8), so every weight
// byte is read once for 2*M flops.  One 7B decode step streams about 6.6 GB
// of int8 weights (32 layers x (qkv 50 MB + o 17 MB + gate_up 90 MB + down
// 45 MB) + a 132 MB lm_head); at the H100's 3.35 TB/s that is ~2 ms, far
// above the tensor-core time.  The design therefore only tries to keep
// enough 16-byte loads in flight:
//   * a block owns a strip of kBlockN = 64 columns for MT rows of x;
//     4 threads cover one 64-byte row piece with one 16-byte load each, and
//     the block's 64 row lanes walk K in steps of 64;
//   * when the strips alone give too few blocks to fill the SMs, K is split
//     over gridDim.z; each split writes f32 partial sums and a second kernel
//     adds them, applies the scale and rounds to bf16;
//   * int8 -> f32 goes through a byte-permute into the mantissa of 2^23
//     (one PRMT and one FADD a value) instead of the slower I2F;
//   * partial sums are reduced with warp shuffles, then across warps in
//     shared memory.
// Plain version and wrapper: groma_tpu_torch/ops/quant.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 64;                         // columns per block
constexpr int kColGroups = kBlockN / 16;            // threads per row piece
constexpr int kRowLanes = kThreads / kColGroups;    // rows per K step

// 4 packed int8 -> 4 exact floats: (v ^ 0x80) is v + 128 as an unsigned
// byte; placed in the low mantissa byte of 2^23 it reads 2^23 + v + 128.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  f[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  f[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  f[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
}

__device__ __forceinline__ void uint4_to_float(const uint4& p, float* f) {
  int8x4_to_float(p.x, f);
  int8x4_to_float(p.y, f + 4);
  int8x4_to_float(p.z, f + 8);
  int8x4_to_float(p.w, f + 12);
}

template <int MT>
__device__ __forceinline__ void accumulate(float (&acc)[MT][16],
                                           const float* wf,
                                           const __nv_bfloat16* __restrict__ x,
                                           int rows, int K, int k) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float xv =
        m < rows ? __bfloat162float(x[(size_t)m * K + k]) : 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ partial,
                   int M, int K, int N, int k_chunk) {
  __shared__ float red[kWarps][MT][kBlockN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = tid % kColGroups;
  const int row_lane = tid / kColGroups;
  const int col0 = blockIdx.x * kBlockN + cg * 16;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const __nv_bfloat16* xm = x + (size_t)m0 * K;

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.0f;

  if (col0 < N) {
    int k = k_begin + row_lane;
    if (N % 16 == 0) {
      // four independent 16-byte loads in flight before any arithmetic
      for (; k + 3 * kRowLanes < k_end; k += 4 * kRowLanes) {
        uint4 p[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          p[u] = __ldg(reinterpret_cast<const uint4*>(
              w + (size_t)(k + u * kRowLanes) * N + col0));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float wf[16];
          uint4_to_float(p[u], wf);
          accumulate<MT>(acc, wf, xm, rows, K, k + u * kRowLanes);
        }
      }
      for (; k < k_end; k += kRowLanes) {
        float wf[16];
        uint4_to_float(__ldg(reinterpret_cast<const uint4*>(
                           w + (size_t)k * N + col0)), wf);
        accumulate<MT>(acc, wf, xm, rows, K, k);
      }
    } else {
      // ragged N: rows are not 16-byte aligned, load bytes one by one
      for (; k < k_end; k += kRowLanes) {
        float wf[16];
        const int8_t* wr = w + (size_t)k * N + col0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          wf[j] = col0 + j < N ? (float)__ldg(wr + j) : 0.0f;
        accumulate<MT>(acc, wf, xm, rows, K, k);
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
      out[(size_t)(m0 + m) * N + col] = __float2bfloat16(s * scale[col]);
    } else {
      partial[((size_t)blockIdx.z * M + m0 + m) * N + col] = s;
    }
  }
}

__global__ void int8_matmul_splitk_epilogue(const float* __restrict__ partial,
                                            const float* __restrict__ scale,
                                            __nv_bfloat16* __restrict__ out,
                                            int M, int N, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (idx >= mn) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += partial[z * mn + idx];
  out[idx] = __float2bfloat16(s * scale[idx % N]);
}

template <int MT>
void launch(const void* x, const void* w, const void* scale, void* out,
            void* partial, int M, int K, int N, int k_chunk, int splits,
            cudaStream_t stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + MT - 1) / MT, splits);
  int8_matmul_kernel<MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, K, N, k_chunk);
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = launched).
// `partial` is an f32 (splits, M, N) workspace, unused when splits == 1;
// k_chunk * splits must cover K.  mt is the row tile: 1, 2, 4 or 8.
extern "C" int groma_int8_matmul(const void* x, const void* w,
                                 const void* scale, void* out, void* partial,
                                 int M, int K, int N, int mt, int k_chunk,
                                 int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: launch<1>(x, w, scale, out, partial, M, K, N, k_chunk, splits, s); break;
    case 2: launch<2>(x, w, scale, out, partial, M, K, N, k_chunk, splits, s); break;
    case 4: launch<4>(x, w, scale, out, partial, M, K, N, k_chunk, splits, s); break;
    case 8: launch<8>(x, w, scale, out, partial, M, K, N, k_chunk, splits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (splits > 1) {
    const size_t mn = (size_t)M * N;
    int8_matmul_splitk_epilogue<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(partial), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), M, N, splits);
  }
  return (int)cudaGetLastError();
}
