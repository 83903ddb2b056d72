// Single-token decode attention over a pool of 128-token int8 KV pages,
// through a per-slot page table, on Hopper (sm_90a).
//
// Replaces the TPU kernel groma_tpu/ops/paged_attention.py `_kernel`
// (entry `paged_int8_decode_attention`, via `_call_kernel`), with its
// per-page numerics.  For one (slot b, head h):
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
// What bounds it: KV bytes.  A slot of L tokens streams 2 L (D + 4) bytes
// a head and does a few integer operations per byte.  So:
//   * One (b, h) is split over a thread-block cluster of C CTAs (the
//     host's `paged_plan`); the CTA of rank r runs the online softmax over
//     the contiguous run [r n / C, (r + 1) n / C) of the row's n pages.
//   * One producer warp reads the page ids from the table ahead of the
//     consumers and keeps kStages pages of K, V and their scales (16 KB +
//     16 KB + 1 KB) in flight through 1-d bulk copies into a ring; K with
//     both scales and V land on their own barriers, so the scores and p8
//     are computed while V arrives.  A stage read with ld.shared is
//     released after fence.proxy.async.
//   * Eight consumer warps each own 16 rows of every page: their scores,
//     p, p8 and their share of p . v (dp4a on 4 x 4 transposed bytes) stay
//     in the warp.  A page takes two barriers of the consumers, one for
//     its max and one for its sum and its r; each warp keeps its own
//     accumulator, with the page's corr and r, and the warps' accumulators
//     are added once at the end.
//   * The cluster merges its runs through distributed shared memory: each
//     CTA pushes (m, l, acc) into rank 0's slot [its rank] with st.async,
//     which counts the bytes on rank 0's mbarrier, and rank 0 adds them in
//     rank order: m* = max m_r, acc = sum acc_r exp(m_r - m*), l = sum l_r
//     exp(m_r - m*), out = acc / max(l, 1e-30).  A page's p8 does not
//     change under a uniform rescale of its p (up to f32 rounding), so
//     this is the TPU kernel's function up to f32 order.  A CTA without
//     pages gives m = -1e30, l = 0, acc = 0: a zero weight, never a NaN.
// One launch, no workspace, no atomics: two calls agree bitwise.  No CTA
// writes another's memory before a cluster barrier shows every CTA running
// with its mbarriers ready, and no CTA reads another's.
// Plain version, plan and wrapper: groma_tpu_torch/ops/paged_attention.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;     // + the producer warp
constexpr int kD = 128;
constexpr int kPage = 128;
constexpr int kWarpRows = kPage / kConsumerWarps;
constexpr int kStages = 3;
constexpr int kKBytes = kPage * kD;
constexpr int kScaleBytes = kPage * 4;
constexpr int kOffV = kKBytes;
constexpr int kOffKs = 2 * kKBytes;             // ks, then vs
constexpr int kOffVs = 2 * kKBytes + kScaleBytes;
constexpr int kStageBytes = 2 * kKBytes + 2 * kScaleBytes;
constexpr int kSmem = kStages * kStageBytes;
constexpr int kMaxCluster = 8;
constexpr float kNeg = -1e30f;

__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const int8_t* __restrict__ kpool,
                       const float* __restrict__ ks,
                       const int8_t* __restrict__ vpool,
                       const float* __restrict__ vs,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths,
                       float* __restrict__ out, int H, int NP, int C,
                       float scale) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full_k[kStages], full_v[kStages], empty[kStages];
  __shared__ uint32_t q8s[kD / 4];
  __shared__ float qs_shared;
  __shared__ float red_m[kConsumerWarps], red_l[kConsumerWarps],
      red_r[kConsumerWarps];
  __shared__ __align__(16) int8_t p8[kPage];
  __shared__ float acc_w[kConsumerWarps][kD];
  // the cluster's runs, each CTA's pushed into rank 0's slot [its rank]
  __shared__ uint64_t bar_x;                  // the pushes' arrivals
  __shared__ float x_m[kMaxCluster], x_l[kMaxCluster];
  __shared__ float x_acc[kMaxCluster][kD];

  const int rank = (int)sm90::cluster_rank();
  const int bh = blockIdx.x / C;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int len = lengths[b];
  const int n = len > 0 ? min(NP, (len + kPage - 1) / kPage) : NP;
  const int p0 = rank * n / C;
  const int mine = (rank + 1) * n / C - p0;
  const int* trow = table + (size_t)b * NP + p0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::mbar_init(&bar_x, 1);
    sm90::mbar_init_fence();
    if (rank == 0) sm90::mbar_arrive_expect_tx(&bar_x, 4 * (kD + 2) * C);
  }
  if (warp == 0) {
    const float qs = decode::quantize_q_row(q + (size_t)bh * kD, q8s);
    if (lane == 0) qs_shared = qs;
  }
  __syncthreads();
  // this CTA runs, its barriers ready: peers may push once they waited
  sm90::cluster_arrive();

  float m_run = kNeg, l_run = 0.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // dims 4 lane .. 4 lane + 3
  if (warp == kConsumerWarps) {
    // the producer: page i into stage i % kStages once its last reader
    // (page i - kStages) is released; the warp's lanes read 32 page ids at
    // a time ahead of it.  K and both scales land on full_k, V on full_v.
    int pid = 0;
    for (int i = 0; i < mine; ++i) {
      if (i % 32 == 0 && i + lane < mine) pid = trow[i + lane];
      const size_t base =
          (size_t)__shfl_sync(0xffffffffu, pid, i % 32) * H + h;
      const int st = i % kStages;
      if (i >= kStages)
        sm90::mbar_wait(&empty[st], ((i / kStages) - 1) & 1);
      if (lane == 0) {
        uint8_t* d = ring + st * kStageBytes;
        sm90::mbar_arrive_expect_tx(&full_k[st], kKBytes + 2 * kScaleBytes);
        sm90::bulk_load(d, kpool + base * kKBytes, kKBytes, &full_k[st]);
        sm90::bulk_load(d + kOffKs, ks + base * kPage, kScaleBytes,
                        &full_k[st]);
        sm90::bulk_load(d + kOffVs, vs + base * kPage, kScaleBytes,
                        &full_k[st]);
        sm90::mbar_arrive_expect_tx(&full_v[st], kKBytes);
        sm90::bulk_load(d + kOffV, vpool + base * kKBytes, kKBytes,
                        &full_v[st]);
      }
    }
    __syncwarp();
  } else {
    const float qscale = __fmul_rn(qs_shared, scale);
    // scores: 8 lanes a key row (a 16-byte slice each), 4 rows a pass
    const int sub = lane & 7;
    const uint4 qw = make_uint4(q8s[4 * sub], q8s[4 * sub + 1],
                                q8s[4 * sub + 2], q8s[4 * sub + 3]);
    const int row0 = kWarpRows * warp + (lane >> 3);   // + 4 t, pass t
    for (int i = 0; i < mine; ++i) {
      const int st = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const uint8_t* d = ring + st * kStageBytes;
      const float* kss = reinterpret_cast<const float*>(d + kOffKs);
      const float* vss = reinterpret_cast<const float*>(d + kOffVs);
      const int pos0 = (p0 + i) * kPage;
      sm90::mbar_wait(&full_k[st], ph);
      float sc[kWarpRows / 4];
      float wmax = decode::neg_inf();
#pragma unroll
      for (int t = 0; t < kWarpRows / 4; ++t) {
        const int row = row0 + 4 * t;
        int dot = decode::dot16(
            *reinterpret_cast<const uint4*>(d + row * kD + 16 * sub), qw);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        const float bias = pos0 + row < len ? 0.0f : kNeg;
        sc[t] = __fadd_rn(
            __fmul_rn(__fmul_rn((float)dot, qscale), kss[row]), bias);
        wmax = fmaxf(wmax, sc[t]);
      }
      wmax = decode::warp_max(wmax);
      if (lane == 0) red_m[warp] = wmax;
      sm90::named_sync(1, kConsumers);
      float pmax = red_m[0];
#pragma unroll
      for (int w = 1; w < kConsumerWarps; ++w) pmax = fmaxf(pmax, red_m[w]);
      const float m_new = fmaxf(m_run, pmax);
      const float corr = expf(__fsub_rn(m_run, m_new));

      float ps[kWarpRows / 4];
      float psum = 0.0f, rmax = 0.0f;
#pragma unroll
      for (int t = 0; t < kWarpRows / 4; ++t) {
        const float p = expf(__fsub_rn(sc[t], m_new));
        ps[t] = __fmul_rn(p, vss[row0 + 4 * t]);
        if (sub == 0) {               // one lane of the row's eight
          psum += p;
          rmax = fmaxf(rmax, ps[t]);
        }
      }
      psum = decode::warp_sum(psum);
      rmax = decode::warp_max(rmax);
      if (lane == 0) {
        red_l[warp] = psum;
        red_r[warp] = rmax;
      }
      sm90::named_sync(1, kConsumers);
      float page_sum = 0.0f, r = 0.0f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        page_sum += red_l[w];
        r = fmaxf(r, red_r[w]);
      }
      r = r > 0.0f ? r / 127.0f : 1.0f;
      if (sub == 0) {
#pragma unroll
        for (int t = 0; t < kWarpRows / 4; ++t)
          p8[row0 + 4 * t] = (int8_t)(int)rintf(ps[t] / r);
      }
      __syncwarp();

      // p . v over the warp's rows, 4 at a time: the 4 x 4 bytes of dims
      // 4 lane.. of rows r0..r0 + 3 transposed into one word a dim, each
      // a dp4a against the rows' p8
      sm90::mbar_wait(&full_v[st], ph);
      int o[4] = {0, 0, 0, 0};
#pragma unroll
      for (int g = 0; g < kWarpRows / 4; ++g) {
        const int r0 = kWarpRows * warp + 4 * g;
        const int pw = *reinterpret_cast<const int*>(p8 + r0);
        const uint8_t* vr = d + kOffV + r0 * kD + 4 * lane;
        const uint32_t a = *reinterpret_cast<const uint32_t*>(vr);
        const uint32_t bb = *reinterpret_cast<const uint32_t*>(vr + kD);
        const uint32_t c = *reinterpret_cast<const uint32_t*>(vr + 2 * kD);
        const uint32_t e = *reinterpret_cast<const uint32_t*>(vr + 3 * kD);
        const uint32_t ab_lo = __byte_perm(a, bb, 0x5140);   // a0 b0 a1 b1
        const uint32_t ce_lo = __byte_perm(c, e, 0x5140);
        const uint32_t ab_hi = __byte_perm(a, bb, 0x7362);   // a2 b2 a3 b3
        const uint32_t ce_hi = __byte_perm(c, e, 0x7362);
        o[0] = __dp4a((int)__byte_perm(ab_lo, ce_lo, 0x5410), pw, o[0]);
        o[1] = __dp4a((int)__byte_perm(ab_lo, ce_lo, 0x7632), pw, o[1]);
        o[2] = __dp4a((int)__byte_perm(ab_hi, ce_hi, 0x5410), pw, o[2]);
        o[3] = __dp4a((int)__byte_perm(ab_hi, ce_hi, 0x7632), pw, o[3]);
      }
      if (i + kStages < mine) {
        // the stage's reads before its bulk-copy refill
        sm90::fence_proxy_async();
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[st]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[k] = __fadd_rn(__fmul_rn(acc[k], corr),
                           __fmul_rn((float)o[k], r));
      l_run = __fadd_rn(__fmul_rn(l_run, corr), page_sum);
      m_run = m_new;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc_w[warp][4 * lane + k] = acc[k];
    sm90::named_sync(1, kConsumers);
  }
  sm90::cluster_wait();
  if (tid < kD) {
    float a = acc_w[0][tid];
#pragma unroll
    for (int w = 1; w < kConsumerWarps; ++w) a = __fadd_rn(a, acc_w[w][tid]);
    sm90::st_async_f32(sm90::map_rank(&x_acc[rank][tid], 0), a,
                       sm90::map_rank(&bar_x, 0));
  }
  if (tid == 0) {
    sm90::st_async_f32(sm90::map_rank(&x_m[rank], 0), m_run,
                       sm90::map_rank(&bar_x, 0));
    sm90::st_async_f32(sm90::map_rank(&x_l[rank], 0), l_run,
                       sm90::map_rank(&bar_x, 0));
  }
  if (rank == 0 && tid < kD) {
    sm90::mbar_wait(&bar_x, 0);
    float m_star = kNeg;
    for (int r = 0; r < C; ++r) m_star = fmaxf(m_star, x_m[r]);
    float a = 0.0f, l = 0.0f;
    for (int r = 0; r < C; ++r) {
      const float w = expf(__fsub_rn(x_m[r], m_star));
      a = __fadd_rn(a, __fmul_rn(x_acc[r][tid], w));
      l = __fadd_rn(l, __fmul_rn(x_l[r], w));
    }
    out[(size_t)bh * kD + tid] = a / fmaxf(l, 1e-30f);
  }
}

}  // namespace

// q (B, H, 1, 128) f32; kpool/vpool (P, H, 128, 128) int8; ks/vs
// (P, H, 128) f32; table (B, NP) int32 page ids in [0, P); lengths (B,)
// int32; out (B, H, 1, 128) f32, all contiguous, the pools and scales
// 16-byte aligned.  C: the CTAs of a (b, h)'s cluster, 1..8.
// Returns a CUDA error code (0 = launched).
extern "C" int groma_paged_attention(const void* q, const void* kpool,
                                     const void* ks, const void* vpool,
                                     const void* vs, const void* table,
                                     const void* lengths, void* out, int B,
                                     int H, int NP, int D, int C,
                                     void* stream) {
  if (D != kD || B < 1 || H < 1 || NP < 1 || C < 1 || C > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  return sm90::launch_cluster(
      paged_attention_kernel, B * H * C, kThreads, (size_t)kSmem,
      (size_t)kSmem, C,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(q),
      static_cast<const int8_t*>(kpool), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vpool), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(lengths),
      static_cast<float*>(out), H, NP, C, (float)(1.0 / sqrt((double)kD)));
}
