// Single-token decode attention over a pool of 128-token int8 KV pages,
// through a per-slot page table, on Hopper (sm_90a).
//
// Replaces the TPU kernel groma_tpu/ops/paged_attention.py `_kernel`
// (entry `paged_int8_decode_attention`, via `_call_kernel`), with its
// numerics and in its order.  For one (slot b, head h):
//   1. q is quantized per (b, h): qs = max|q| / 127, q8 = rint(q / qs);
//   then for each page p of the slot's table row, in order:
//   2. s = (q8 . k8) as int32, x qs * D^-0.5 x ks, + (pos < length ? 0 :
//      -1e30), with pos = 128 p + offset;
//   3. m' = max(m, max s), corr = exp(m - m'), pv = exp(s - m'),
//      l = l corr + sum pv;
//   4. ps = pv * vs, requantized with this page's own r = max ps / 127;
//   5. acc = acc corr + (p8 . v8) r, the dot in int32;
//   and finally out = acc / max(l, 1e-30).
// rintf rounds half to even, like jnp.round; divisions are IEEE.
//
// Pages past a slot's length are not read: there every s is -1e30, so
// corr = 1, pv = 0 and the page adds exactly nothing.  A FROZEN slot
// (length 0) is the exception: every s of every page is -1e30, m stays
// -1e30, and the TPU kernel averages each page with uniform p (it does not
// give 0).  This kernel walks all its table's pages too, so its output is
// the TPU kernel's there as well (finite, and discarded by the engine).
//
// What bounds it: KV bytes.  A slot of L tokens streams 2 L D bytes a head
// and does a few integer operations per byte.  One block of 256 threads
// owns one (b, h) and walks its pages: 8 lanes take a 128-byte key row
// (16 bytes and 4 dp4a each), a warp 4 consecutive rows, so the loads are
// coalesced; the page's value rows are loaded at the start of the page, so
// they are in flight during the score pass; p . v accumulates in int32,
// 16 dims a lane.  The running max, denominator and accumulator live in
// registers across pages (the TPU kernel's VMEM scratch).
// Plain version and wrapper: groma_tpu_torch/ops/paged_attention.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using decode::sbyte;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 128;
constexpr int kPage = 128;
constexpr float kNeg = -1e30f;

__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const int8_t* __restrict__ kpool,
                       const float* __restrict__ ks,
                       const int8_t* __restrict__ vpool,
                       const float* __restrict__ vs,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths,
                       float* __restrict__ out, int H, int NP, float scale) {
  __shared__ float scores[kPage];
  __shared__ int8_t p8[kPage];
  __shared__ float red[kWarps];
  __shared__ uint32_t q8s[kD / 4];
  __shared__ float qs_shared;
  __shared__ int red_o[kWarps][kD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (warp == 0) {
    const float qs = decode::quantize_q_row(q + (size_t)bh * kD, q8s);
    if (lane == 0) qs_shared = qs;
  }
  __syncthreads();
  const float qscale = __fmul_rn(qs_shared, scale);

  const int len = lengths[b];
  const int n_pages = len > 0 ? min(NP, (len + kPage - 1) / kPage) : NP;
  const int* trow = table + (size_t)b * NP;

  // scores: 8 lanes a key row, 4 rows a warp, 32 rows a pass
  const int sub = lane & 7;
  const int row_in_warp = lane >> 3;
  const uint4 qw = make_uint4(q8s[4 * sub], q8s[4 * sub + 1],
                              q8s[4 * sub + 2], q8s[4 * sub + 3]);
  // p . v: 8 lanes a value row (16 dims each), 32 rows a pass
  const int dg = tid & 7;
  const int pos_lane = tid >> 3;

  float m_run = kNeg, l_run = 0.0f, acc = 0.0f;   // acc: dim tid (< kD)
  for (int pg = 0; pg < n_pages; ++pg) {
    const size_t base = (size_t)trow[pg] * H + h;
    const int8_t* krows = kpool + base * kPage * kD;
    const int8_t* vrows = vpool + base * kPage * kD;
    const float* ksr = ks + base * kPage;
    const float* vsr = vs + base * kPage;

    uint4 vw[kPage / 32];
#pragma unroll
    for (int i = 0; i < kPage / 32; ++i)
      vw[i] = __ldg(reinterpret_cast<const uint4*>(
                        vrows + (size_t)(pos_lane + 32 * i) * kD) + dg);

    float local_max = decode::neg_inf();
#pragma unroll
    for (int i = 0; i < kPage / 32; ++i) {
      const int pos = 32 * i + 4 * warp + row_in_warp;
      const uint4 kw = __ldg(reinterpret_cast<const uint4*>(
                                 krows + (size_t)pos * kD) + sub);
      int dot = decode::dot16(kw, qw);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      if (sub == 0) {
        const float bias = pg * kPage + pos < len ? 0.0f : kNeg;
        const float s = __fadd_rn(
            __fmul_rn(__fmul_rn((float)dot, qscale), ksr[pos]), bias);
        scores[pos] = s;
        local_max = fmaxf(local_max, s);
      }
    }
    const float m_new =
        fmaxf(m_run, decode::block_max<kWarps>(local_max, red));
    const float corr = expf(__fsub_rn(m_run, m_new));

    float psum = 0.0f, rmax = 0.0f;
    if (tid < kPage) {
      psum = expf(__fsub_rn(scores[tid], m_new));
      rmax = __fmul_rn(psum, vsr[tid]);
      scores[tid] = rmax;
    }
    const float page_sum = decode::block_sum<kWarps>(psum, red);
    float r = decode::block_max<kWarps>(rmax, red);
    r = r > 0.0f ? r / 127.0f : 1.0f;
    if (tid < kPage) p8[tid] = (int8_t)(int)rintf(scores[tid] / r);
    __syncthreads();

    int o16[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) o16[j] = 0;
#pragma unroll
    for (int i = 0; i < kPage / 32; ++i) {
      const int p = p8[pos_lane + 32 * i];
      const uint32_t words[4] = {vw[i].x, vw[i].y, vw[i].z, vw[i].w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi)
#pragma unroll
        for (int e = 0; e < 4; ++e) o16[4 * wi + e] += p * sbyte(words[wi], e);
    }
    // lanes sharing dg differ in bits 3..4 of the lane id
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int v = o16[j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      o16[j] = v;
    }
    if (lane < 8) {
#pragma unroll
      for (int j = 0; j < 16; ++j) red_o[warp][dg * 16 + j] = o16[j];
    }
    __syncthreads();
    if (tid < kD) {
      int o = 0;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) o += red_o[wi][tid];
      acc = __fadd_rn(__fmul_rn(acc, corr), __fmul_rn((float)o, r));
    }
    l_run = __fadd_rn(__fmul_rn(l_run, corr), page_sum);
    m_run = m_new;
    __syncthreads();   // scores, p8 and red_o are rewritten by the next page
  }
  if (tid < kD) out[(size_t)bh * kD + tid] = acc / fmaxf(l_run, 1e-30f);
}

}  // namespace

// q (B, H, 1, 128) f32; kpool/vpool (P, H, 128, 128) int8; ks/vs
// (P, H, 128) f32; table (B, NP) int32 page ids in [0, P); lengths (B,)
// int32; out (B, H, 1, 128) f32, all contiguous.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int groma_paged_attention(const void* q, const void* kpool,
                                     const void* ks, const void* vpool,
                                     const void* vs, const void* table,
                                     const void* lengths, void* out, int B,
                                     int H, int NP, int D, void* stream) {
  if (D != kD || B < 1 || H < 1 || NP < 1) return (int)cudaErrorInvalidValue;
  paged_attention_kernel<<<B * H, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kpool),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vpool),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(out), H, NP,
      (float)(1.0 / sqrt((double)kD)));
  return (int)cudaGetLastError();
}
