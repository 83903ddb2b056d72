// Single-token decode attention over an int8 KV cache, on Hopper (sm_90a).
//
// Replaces the TPU kernel groma_tpu/ops/decode_attention.py `_kernel`
// (entry `int8_decode_attention`, via `_call_kernel`), with its numerics and
// in its order:
//   1. q is quantized per (b, h) row: qs = max|q| / 127, q8 = rint(q / qs);
//   2. scores = (q8 . k8[pos]) as int32, x qs * D^-0.5 x ks[pos], + bias;
//   3. p = exp(s - max s) in f32, denom = sum p;
//   4. ps = p * vs[pos], requantized to int8 with r = max ps / 127;
//   5. o = (p8 . v8) as int32, scaled by r / denom.
// rintf rounds half to even, like jnp.round.  Unlike the TPU wrapper, which
// falls back to an XLA chain whenever S % 128 != 0, this kernel takes any S
// (up to kMaxS, the shared-memory bound below); D must be 128.
//
// What bounds it: KV bytes.  Each (b, h) streams its k8 and v8 rows once,
// 2 * S * D bytes, and does a few integer operations per byte.  One block
// owns one (b, h): it keeps the S scores in shared memory (4 bytes each)
// plus the S int8 probabilities, takes the q.k dots with __dp4a (8 lanes a
// 128-byte key row, 16 bytes each), and accumulates p.v in int32 with one
// 16-byte value load per lane.  Each warp reads 4 consecutive 128-byte rows
// per step, so every load is coalesced.
// Plain version and wrapper: groma_tpu_torch/ops/decode_attention.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using decode::neg_inf;
using decode::sbyte;

constexpr int kThreads = 1024;   // one block per (b, h): many loads in flight
constexpr int kWarps = kThreads / 32;
constexpr int kD = 128;
constexpr int kMaxS = 4096;   // 5 * S bytes of dynamic shared memory

__global__ void __launch_bounds__(kThreads)
int8_decode_attention_kernel(const float* __restrict__ q,
                             const int8_t* __restrict__ k8,
                             const float* __restrict__ ks,
                             const int8_t* __restrict__ v8,
                             const float* __restrict__ vs,
                             const float* __restrict__ bias,
                             float* __restrict__ out,
                             int H, int S, float scale) {
  extern __shared__ float smem[];
  float* scores = smem;                                  // S floats
  int8_t* p8 = reinterpret_cast<int8_t*>(smem + S);      // S bytes
  __shared__ float red[kWarps];
  __shared__ uint32_t q8s[kD / 4];
  __shared__ float qs_shared;
  __shared__ int red_o[kWarps][kD];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int8_t* krows = k8 + (size_t)bh * S * kD;
  const int8_t* vrows = v8 + (size_t)bh * S * kD;
  const float* ksr = ks + (size_t)bh * S;
  const float* vsr = vs + (size_t)bh * S;
  const float* br = bias + (size_t)b * S;

  // 1. quantize q: lane l packs dims 4l..4l+3 into one word
  if (warp == 0) {
    const float qs = decode::quantize_q_row(q + (size_t)bh * kD, q8s);
    if (lane == 0) qs_shared = qs;
  }
  __syncthreads();
  const float qscale = __fmul_rn(qs_shared, scale);

  // 2. scores: 8 lanes per key row, each a 16-byte slice, 4 rows a warp
  const int sub = lane & 7;
  const int row_in_warp = lane >> 3;
  const uint4 qw = make_uint4(q8s[4 * sub], q8s[4 * sub + 1],
                              q8s[4 * sub + 2], q8s[4 * sub + 3]);
  float local_max = neg_inf();
  for (int base = warp * 4; base < S; base += kWarps * 4) {
    const int pos = base + row_in_warp;
    int dot = 0;
    if (pos < S) {
      const uint4 kw = __ldg(reinterpret_cast<const uint4*>(
                                 krows + (size_t)pos * kD) + sub);
      dot = decode::dot16(kw, qw);
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 4);
    if (pos < S && sub == 0) {
      const float s = __fadd_rn(
          __fmul_rn(__fmul_rn((float)dot, qscale), ksr[pos]), br[pos]);
      scores[pos] = s;
      local_max = fmaxf(local_max, s);
    }
  }
  const float m = decode::block_max<kWarps>(local_max, red);

  // 3-4. exp, denominator, fold the v scale into p, its max
  float dsum = 0.0f, rmax = 0.0f;
  for (int pos = tid; pos < S; pos += kThreads) {
    const float p = expf(__fsub_rn(scores[pos], m));
    dsum += p;
    const float ps = __fmul_rn(p, vsr[pos]);
    scores[pos] = ps;
    rmax = fmaxf(rmax, ps);
  }
  const float denom = decode::block_sum<kWarps>(dsum, red);
  float r = decode::block_max<kWarps>(rmax, red);
  r = r > 0.0f ? r / 127.0f : 1.0f;
  for (int pos = tid; pos < S; pos += kThreads)
    p8[pos] = (int8_t)(int)rintf(scores[pos] / r);
  __syncthreads();

  // 5. p . v in int32: lane owns 16 dims of one position per step
  const int dg = tid & 7;
  const int pos_lane = tid >> 3;
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
#pragma unroll 4
  for (int pos = pos_lane; pos < S; pos += kThreads / 8) {
    const uint4 vw = __ldg(reinterpret_cast<const uint4*>(
                               vrows + (size_t)pos * kD) + dg);
    const int p = p8[pos];
    const uint32_t words[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
    for (int wi = 0; wi < 4; ++wi)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * wi + i] += p * sbyte(words[wi], i);
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
    for (int j = 0; j < 16; ++j) red_o[warp][dg * 16 + j] = acc[j];
  }
  __syncthreads();
  if (tid < kD) {
    int o = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) o += red_o[wi][tid];
    out[(size_t)bh * kD + tid] =
        __fmul_rn((float)o, r / fmaxf(denom, 1e-30f));
  }
}

}  // namespace

// q (B, H, 1, 128) f32; k8/v8 (B, H, S, 128) int8; ks/vs (B, H, S) f32;
// bias (B, 1, 1, S) f32; out (B, H, 1, 128) f32, all contiguous.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int groma_int8_decode_attention(const void* q, const void* k8,
                                           const void* ks, const void* v8,
                                           const void* vs, const void* bias,
                                           void* out, int B, int H, int S,
                                           int D, void* stream) {
  if (D != kD || S < 1 || S > kMaxS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * sizeof(float) + (size_t)S;
  int8_decode_attention_kernel<<<B * H, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const float*>(vs), static_cast<const float*>(bias),
      static_cast<float*>(out), H, S, (float)(1.0 / sqrt((double)kD)));
  return (int)cudaGetLastError();
}
