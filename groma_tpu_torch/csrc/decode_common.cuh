// Helpers shared by the decode kernels: warp and block reductions (every
// thread of a block of kWarps warps returns the block-wide result; `red`
// holds kWarps floats), int8 dot products and q quantization for the
// single-token attention kernels (decode_attention.cu, paged_attention.cu,
// decode_megakernel.cu).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode {

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int kWarps>
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = warp_max(lane < kWarps ? red[lane] : neg_inf());
  __syncthreads();
  return v;
}

template <int kWarps>
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = warp_sum(lane < kWarps ? red[lane] : 0.0f);
  __syncthreads();
  return v;
}

__device__ __forceinline__ int sbyte(uint32_t w, int i) {
  return (int)(int8_t)(uint8_t)(w >> (8 * i));
}

// One warp quantizes a 128-dim q row whose dims 4l..4l+3 lane l holds in
// `qv`: lane l packs dims 4l..4l+3 of rint(q / qs) into one word of q8s;
// returns qs = max|q| / 127 (1 for a zero row) to every lane.  IEEE
// division, rintf rounds half to even.
__device__ __forceinline__ float quantize_q_vec(const float4 qv,
                                                uint32_t* q8s) {
  const int lane = threadIdx.x & 31;
  const float a = warp_max(fmaxf(fmaxf(fabsf(qv.x), fabsf(qv.y)),
                                 fmaxf(fabsf(qv.z), fabsf(qv.w))));
  const float qs = a > 0.0f ? a / 127.0f : 1.0f;
  const uint32_t b0 = (uint32_t)((int)rintf(qv.x / qs) & 0xff);
  const uint32_t b1 = (uint32_t)((int)rintf(qv.y / qs) & 0xff);
  const uint32_t b2 = (uint32_t)((int)rintf(qv.z / qs) & 0xff);
  const uint32_t b3 = (uint32_t)((int)rintf(qv.w / qs) & 0xff);
  q8s[lane] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
  return qs;
}

// quantize_q_vec of the row at q (one warp).
__device__ __forceinline__ float quantize_q_row(const float* q, uint32_t* q8s) {
  return quantize_q_vec(reinterpret_cast<const float4*>(q)[threadIdx.x & 31],
                        q8s);
}

// dp4a of one 16-byte int8 key slice against the matching q8 slice.
__device__ __forceinline__ int dot16(const uint4& kw, const uint4& qw) {
  int dot = __dp4a((int)kw.x, (int)qw.x, 0);
  dot = __dp4a((int)kw.y, (int)qw.y, dot);
  dot = __dp4a((int)kw.z, (int)qw.z, dot);
  return __dp4a((int)kw.w, (int)qw.w, dot);
}

}  // namespace decode
