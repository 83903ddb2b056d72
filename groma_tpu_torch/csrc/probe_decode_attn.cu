// H100 probe of the decode-attention structure over an int8 KV cache
// (sm_90a).
//
// Replaces the TPU probe kernels `k_floor`, `k_mxu` and `k_mxu_sblk` of
// benchmarks/exp_decode_attn_variants.py, which sweep how the grid carves
// the KV stream (heads a block, S blocks, one launch for all layers), not
// what the body computes.  One template over the body and the grid:
//   BODY 0 (`k_floor`): per (b, h, d): sum_s k8 + sum_s v8 (int32), plus
//          sum_s ks + sum_s vs + bias[b, 0, 0, 0], in f32: the memory floor
//          of the structure;
//   BODY 1 (`k_mxu`): the whole-S int8 body of #2 (decode_attention.cu),
//          in its order and roundings;
//   BODY 2 (`k_mxu_sblk`): the same body over one S block, with that
//          block's own max, denominator and requantization of p; writes
//          (m, d, o * r) of the block, and a second kernel combines the
//          blocks: o = sum_i o_i e^(m_i - m) / max(sum_i d_i e^(m_i - m),
//          1e-30).  The TPU runs the S blocks in order with a running max;
//          here they run in parallel.  The function is the same up to f32
//          order: a block's requantized p is invariant to the uniform exp
//          rescale.
// Grid: x = (b, group of HB heads) processed one head after another by the
// block's 256 threads (HB = 1 is #2's grid, one block per (b, head)),
// y = S block, z = layer (one launch for L independent layers, the TPU's
// `Lstack`; q and the bias are shared by the layers, as the TPU probe
// broadcasts them).  What bounds it: the KV bytes (2 S D int8 + 8 S of
// scales per (b, h)); the probe shows how far each structure is from them.
// Plain versions and wrapper:
// groma_tpu_torch/benchmarks/exp_decode_attn_variants.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using decode::neg_inf;
using decode::sbyte;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 128;
constexpr int kPosLanes = kThreads / 8;   // positions a step of the p.v loop
constexpr int kMaxS = 4096;               // 5 bytes a position in shared

struct Args {
  const float* q;       // (B, H, 1, D), shared by the layers
  const int8_t* k8;     // (L, B, H, S, D)
  const float* ks;      // (L, B, H, S)
  const int8_t* v8;
  const float* vs;
  const float* bias;    // (B, 1, 1, S), shared by the layers
  float* out;           // (L, B, H, 1, D)
  float* m_part;        // BODY 2: (L, B, H, nsb)
  float* d_part;
  float* o_part;        // BODY 2: (L, B, H, nsb, D)
  int B, H, S, sblk;
  float scale;
};

// Sums of the d-slice `dg` (16 dims) of the int8 rows s0 .. s1-1 of `rows`
// over this thread's positions, added into acc.
__device__ __forceinline__ void column_sums(const int8_t* rows, int s0, int s1,
                                            int pos_lane, int dg, int* acc) {
  for (int pos = s0 + pos_lane; pos < s1; pos += kPosLanes) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(
                              rows + (size_t)pos * kD) + dg);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int wi = 0; wi < 4; ++wi)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * wi + i] += sbyte(words[wi], i);
  }
}

// acc[16] of every thread -> red_o[d] = block-wide sum (lanes sharing dg
// differ in bits 3..4 of the lane id).
__device__ __forceinline__ void reduce_columns(int* acc, int (*red_o)[kD]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int v = acc[j];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    acc[j] = v;
  }
  if (lane < 8) {
#pragma unroll
    for (int j = 0; j < 16; ++j) red_o[warp][(tid & 7) * 16 + j] = acc[j];
  }
  __syncthreads();
}

template <int BODY, int HB>
__global__ void __launch_bounds__(kThreads) probe_attn_kernel(Args a) {
  extern __shared__ float smem[];
  float* scores = smem;                                   // sblk floats
  int8_t* p8 = reinterpret_cast<int8_t*>(smem + a.sblk);  // sblk bytes
  __shared__ float red[kWarps];
  __shared__ uint32_t q8s[kD / 4];
  __shared__ float qs_shared;
  __shared__ int red_o[kWarps][kD];

  const int groups = a.H / HB;
  const int b = blockIdx.x / groups, hg = blockIdx.x % groups;
  const int sb = blockIdx.y, nsb = gridDim.y, layer = blockIdx.z;
  const int s0 = sb * a.sblk, s1 = min(a.S, s0 + a.sblk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dg = tid & 7, pos_lane = tid >> 3;
  const size_t lkv = (size_t)layer * a.B * a.H;    // (b, h) rows before
  const float* br = a.bias + (size_t)b * a.S;

  for (int hi = 0; hi < HB; ++hi) {
    const int bh = b * a.H + hg * HB + hi;
    const size_t row = lkv + bh;
    const int8_t* krows = a.k8 + row * a.S * kD;
    const int8_t* vrows = a.v8 + row * a.S * kD;
    const float* ksr = a.ks + row * a.S;
    const float* vsr = a.vs + row * a.S;
    int acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0;

    if (BODY == 0) {
      column_sums(krows, s0, s1, pos_lane, dg, acc);
      column_sums(vrows, s0, s1, pos_lane, dg, acc);
      float sk = 0.0f, sv = 0.0f;
      for (int pos = s0 + tid; pos < s1; pos += kThreads) {
        sk += ksr[pos];
        sv += vsr[pos];
      }
      sk = decode::block_sum<kWarps>(sk, red);
      sv = decode::block_sum<kWarps>(sv, red);
      reduce_columns(acc, red_o);
      if (tid < kD) {
        int t = 0;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) t += red_o[wi][tid];
        a.out[row * kD + tid] = (float)t + sk + sv + br[0];
      }
      __syncthreads();
      continue;
    }

    // 1. quantize q: lane l packs dims 4l..4l+3 into one word
    if (warp == 0) {
      const float qs = decode::quantize_q_row(a.q + (size_t)bh * kD, q8s);
      if (lane == 0) qs_shared = qs;
    }
    __syncthreads();
    const float qscale = __fmul_rn(qs_shared, a.scale);

    // 2. scores: 8 lanes per key row, each a 16-byte slice, 4 rows a warp
    const int sub = lane & 7, row_in_warp = lane >> 3;
    const uint4 qw = make_uint4(q8s[4 * sub], q8s[4 * sub + 1],
                                q8s[4 * sub + 2], q8s[4 * sub + 3]);
    float local_max = neg_inf();
    for (int base = s0 + warp * 4; base < s1; base += kWarps * 4) {
      const int pos = base + row_in_warp;
      int dot = 0;
      if (pos < s1) {
        const uint4 kw = __ldg(reinterpret_cast<const uint4*>(
                                   krows + (size_t)pos * kD) + sub);
        dot = decode::dot16(kw, qw);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      if (pos < s1 && sub == 0) {
        const float s = __fadd_rn(
            __fmul_rn(__fmul_rn((float)dot, qscale), ksr[pos]), br[pos]);
        scores[pos - s0] = s;
        local_max = fmaxf(local_max, s);
      }
    }
    const float m = decode::block_max<kWarps>(local_max, red);

    // 3-4. exp, denominator, the v scale folded into p, its max
    float dsum = 0.0f, rmax = 0.0f;
    for (int i = tid; i < s1 - s0; i += kThreads) {
      const float p = expf(__fsub_rn(scores[i], m));
      dsum += p;
      const float ps = __fmul_rn(p, vsr[s0 + i]);
      scores[i] = ps;
      rmax = fmaxf(rmax, ps);
    }
    const float denom = decode::block_sum<kWarps>(dsum, red);
    float r = decode::block_max<kWarps>(rmax, red);
    r = r > 0.0f ? r / 127.0f : 1.0f;
    for (int i = tid; i < s1 - s0; i += kThreads)
      p8[i] = (int8_t)(int)rintf(scores[i] / r);
    __syncthreads();

    // 5. p . v in int32: a thread owns 16 dims of one position a step
    for (int pos = s0 + pos_lane; pos < s1; pos += kPosLanes) {
      const uint4 vw = __ldg(reinterpret_cast<const uint4*>(
                                 vrows + (size_t)pos * kD) + dg);
      const int p = p8[pos - s0];
      const uint32_t words[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[4 * wi + i] += p * sbyte(words[wi], i);
    }
    reduce_columns(acc, red_o);
    if (tid < kD) {
      int o = 0;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) o += red_o[wi][tid];
      if (BODY == 1) {
        a.out[row * kD + tid] = __fmul_rn((float)o, r / fmaxf(denom, 1e-30f));
      } else {
        const size_t part = row * nsb + sb;
        a.o_part[part * kD + tid] = __fmul_rn((float)o, r);
        if (tid == 0) {
          a.m_part[part] = m;
          a.d_part[part] = denom;
        }
      }
    }
    __syncthreads();
  }
}

// BODY 2's second pass: one block of D threads per (layer, b, h).
__global__ void __launch_bounds__(kD) probe_attn_combine(Args a, int nsb) {
  const size_t row = (size_t)blockIdx.z * a.B * a.H + blockIdx.x;
  const int d = threadIdx.x;
  const float* mp = a.m_part + row * nsb;
  const float* dp = a.d_part + row * nsb;
  float m = neg_inf();
  for (int i = 0; i < nsb; ++i) m = fmaxf(m, mp[i]);
  float den = 0.0f, o = 0.0f;
  for (int i = 0; i < nsb; ++i) {
    const float w = expf(__fsub_rn(mp[i], m));
    den = fmaf(dp[i], w, den);
    o = fmaf(a.o_part[(row * nsb + i) * kD + d], w, o);
  }
  a.out[row * kD + d] = o / fmaxf(den, 1e-30f);
}

template <int BODY>
int launch_body(const Args& a, int hb, int L, cudaStream_t s) {
  const int nsb = (a.S + a.sblk - 1) / a.sblk;
  const dim3 grid(a.B * a.H / hb, nsb, L);
  const size_t smem = (size_t)a.sblk * sizeof(float) + (size_t)a.sblk;
  switch (hb) {
    case 1: probe_attn_kernel<BODY, 1><<<grid, kThreads, smem, s>>>(a); break;
    case 8: probe_attn_kernel<BODY, 8><<<grid, kThreads, smem, s>>>(a); break;
    case 16: probe_attn_kernel<BODY, 16><<<grid, kThreads, smem, s>>>(a); break;
    case 32: probe_attn_kernel<BODY, 32><<<grid, kThreads, smem, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (BODY == 2) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    probe_attn_combine<<<dim3(a.B * a.H, 1, L), kD, 0, s>>>(a, nsb);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, 1, 128) f32; k8/v8 (L, B, H, S, 128) int8; ks/vs (L, B, H, S)
// f32; bias (B, 1, 1, S) f32; out (L, B, H, 1, 128) f32; body 0 (floor),
// 1 (whole-S) or 2 (S blocks of sblk, with partials m/d (L, B, H, nsb) and
// o (L, B, H, nsb, 128) f32); hb in {1, 8, 16, 32} dividing H; body 0 and 1
// take sblk = S.  All contiguous.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int groma_probe_decode_attn(const void* q, const void* k8,
                                       const void* ks, const void* v8,
                                       const void* vs, const void* bias,
                                       void* out, void* m_part, void* d_part,
                                       void* o_part, int L, int B, int H,
                                       int S, int D, int body, int hb,
                                       int sblk, void* stream) {
  if (D != kD || L < 1 || B < 1 || H < 1 || hb < 1 || H % hb || S < 1
      || sblk < 1 || sblk > kMaxS || (body != 2 && sblk != S))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), static_cast<const int8_t*>(k8),
         static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
         static_cast<const float*>(vs), static_cast<const float*>(bias),
         static_cast<float*>(out), static_cast<float*>(m_part),
         static_cast<float*>(d_part), static_cast<float*>(o_part),
         B, H, S, sblk, (float)(1.0 / sqrt((double)kD))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0: return launch_body<0>(a, hb, L, s);
    case 1: return launch_body<1>(a, hb, L, s);
    case 2: return launch_body<2>(a, hb, L, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
