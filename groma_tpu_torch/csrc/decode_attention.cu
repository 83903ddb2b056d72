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
// up to kMaxS; D must be 128.
//
// What bounds it: KV bytes, 2 * D bytes a row read, a few integer
// operations a byte.  Two things follow.
//
// Only the rows the mask keeps are read.  A slot is kept when its bias is
// above -1e29.  Under the contract's bias (0 or -1e30), whenever some slot
// of a row is kept, a masked slot adds exactly nothing: its score is about
// -1e30, so p = exp(s - m) underflows to exactly 0 (f32 exp is 0 below
// about -104), ps = 0 and p8 = 0; the int32 sum and the denominator add 0,
// and the max of ps, which starts at 0, does not move.  Only a row with
// no kept slot needs every slot: there m = -1e30 and every p is 1, so all
// S slots are its list and p is uniform, as before.  Any other finite bias
// is above the threshold, so its slot is simply kept.  The served stream is
// padded to max_seq_len and cached by stream slot, so at decode about a
// quarter of its slots are kept.
//
// One (b, h) is split over a thread-block cluster of C CTAs (the host's
// `decode_attention_plan`: about one wave of two CTAs a SM).  Each CTA
// brings the row's bias and scales into shared memory (bulk copies, the
// scales on a barrier of their own), builds the list of kept slots with a
// block prefix sum, and takes the list's 64-row chunks round-robin (chunk
// j to rank j % C), so the work is even whatever the shape of the mask.
// Its chunks' key rows, then their value rows, go through a ring of 64-row
// stages filled by 1-d bulk copies, one per run of consecutive kept slots
// (from ballots over the list, by the warp of the item), so the value rows
// are in flight while the scores are computed.  A stage read with
// ld.shared and then refilled is released after fence.proxy.async.
// The CTAs meet through distributed shared memory: each pushes its
// partials into slot [its rank] of its peers with st.async, which counts
// the bytes on the peer's mbarrier, and each waits on its own; no cluster
// barrier after the first.  Every number is the one-block kernel's but for
// the order of the denominator's sum:
//   * m is the max of the CTAs' maxima (exact); p = exp(s - m) with this
//     global m, so p, ps, r and p8 are bit for bit the one-block values;
//   * the denominator adds the CTAs' partial sums in rank order (so two
//     calls agree bitwise); r is the max of their maxima of ps (exact);
//   * rank 0 adds the CTAs' int32 p . v partials (exact) and writes out.
// One launch, no workspace, no atomics.  No CTA writes another's memory
// before a cluster barrier shows every CTA running with its mbarriers
// ready, and no CTA reads another's: a CTA exits once what it was sent has
// arrived.
// Plain version, plan and wrapper: groma_tpu_torch/ops/decode_attention.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "sm90_common.cuh"

namespace {

using decode::neg_inf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 128;
constexpr int kRows = 64;       // rows of a chunk and a stage, 32 a pass
constexpr int kStageBytes = kRows * kD;
constexpr int kMaxStages = 16;  // the ring: 2..16 stages, a power of two
constexpr int kMaxS = 4096;                   // the list holds uint16 slots
constexpr int kPer = kMaxS / kThreads;        // slots a thread scans
constexpr int kMaxCluster = 8;
constexpr float kKeep = -1e29f;               // bias above: the slot is kept

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// dynamic shared memory: the ring; the kept list; by slot, the bias (later
// the score, then ps), the k scale and the v scale; p8 by list position
__host__ __device__ constexpr int smem_bytes(int S, int stages) {
  return stages * kStageBytes + align16(2 * S) + 12 * S + align16(S);
}

__global__ void __launch_bounds__(kThreads)
int8_decode_attention_kernel(const float* __restrict__ q,
                             const int8_t* __restrict__ k8,
                             const float* __restrict__ ks,
                             const int8_t* __restrict__ v8,
                             const float* __restrict__ vs,
                             const float* __restrict__ bias,
                             float* __restrict__ out,
                             int H, int S, int C, int lg_stages,
                             float scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int stages = 1 << lg_stages;
  uint8_t* ring = smem;
  uint16_t* list =
      reinterpret_cast<uint16_t*>(smem + stages * kStageBytes);
  float* sb = reinterpret_cast<float*>(
      smem + stages * kStageBytes + align16(2 * S));
  float* sk = sb + S;
  float* sv = sk + S;
  int8_t* p8 = reinterpret_cast<int8_t*>(sv + S);
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ uint64_t bar_in, bar_sc, bar_m, bar_r, bar_o;
  __shared__ float red[kWarps], red2[kWarps];
  __shared__ int scan[kWarps];
  __shared__ uint32_t q8s[kD / 4];
  __shared__ float qs_shared;
  __shared__ int red_o[kWarps][kD];
  // slot [r]: what the CTA of rank r pushed (the p . v partials to rank 0)
  __shared__ float x_m[kMaxCluster], x_sum[kMaxCluster], x_r[kMaxCluster];
  __shared__ int x_o[kMaxCluster][kD];

  const int rank = (int)sm90::cluster_rank();
  const int bh = blockIdx.x / C;
  const int b = bh / H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int8_t* krows = k8 + (size_t)bh * S * kD;
  const int8_t* vrows = v8 + (size_t)bh * S * kD;
  const float* ksr = ks + (size_t)bh * S;
  const float* vsr = vs + (size_t)bh * S;
  const float* br = bias + (size_t)b * S;
  // the row's bias and scales come in as three bulk copies where they are
  // 16-byte aligned, else by plain loads
  const bool bulk = S % 4 == 0
      && ((reinterpret_cast<uintptr_t>(br) | reinterpret_cast<uintptr_t>(ksr)
           | reinterpret_cast<uintptr_t>(vsr)) & 15) == 0;

  // warp 0's lanes load q now; it is quantized once the list is built
  const float4 qv = warp == 0 ? reinterpret_cast<const float4*>(
                                    q + (size_t)bh * kD)[lane]
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWarps);
    }
    sm90::mbar_init(&bar_in, 1);
    sm90::mbar_init(&bar_sc, 1);
    sm90::mbar_init(&bar_m, 1);
    sm90::mbar_init(&bar_r, 1);
    sm90::mbar_init(&bar_o, 1);
    sm90::mbar_init_fence();
    if (bulk) {       // the scales arrive while the list is built
      sm90::mbar_arrive_expect_tx(&bar_in, 4 * S);
      sm90::bulk_load(sb, br, 4 * S, &bar_in);
      sm90::mbar_arrive_expect_tx(&bar_sc, 8 * S);
      sm90::bulk_load(sk, ksr, 4 * S, &bar_sc);
      sm90::bulk_load(sv, vsr, 4 * S, &bar_sc);
    }
    sm90::mbar_arrive_expect_tx(&bar_m, 4 * C);
    sm90::mbar_arrive_expect_tx(&bar_r, 8 * C);
    if (rank == 0) sm90::mbar_arrive_expect_tx(&bar_o, 4 * kD * C);
  }
  if (!bulk) {
    for (int i = tid; i < S; i += kThreads) {
      sb[i] = br[i];
      sk[i] = ksr[i];
      sv[i] = vsr[i];
    }
  }
  __syncthreads();
  // this CTA runs, its barriers ready: peers may push once they waited
  sm90::cluster_arrive();
  if (bulk) sm90::mbar_wait(&bar_in, 0);

  // the kept slots in order: thread t counts the kept slots of its
  // contiguous share [lo, hi) of S, a block scan of the counts gives each
  // thread its start in the list (every slot, with a uniform p, when none
  // is kept)
  const int per = (S + kThreads - 1) / kThreads;
  const int lo = tid * per;
  float bl[kPer];
  int cnt = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    bl[u] = u < per && lo + u < S ? sb[lo + u] : neg_inf();
    cnt += bl[u] > kKeep;
  }
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  int at = incl - cnt, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = scan[w];
    if (w < warp) at += v;
    total += v;
  }
  const bool any = total > 0;
  if (!any) at = lo;
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (u < per && lo + u < S && (!any || bl[u] > kKeep))
      list[at++] = (uint16_t)(lo + u);
  const int n = any ? total : S;
  const int chunks = (n + kRows - 1) / kRows;
  const int nloc = rank < chunks ? (chunks - rank + C - 1) / C : 0;
  const int items = 2 * nloc;        // key chunks, then value chunks
  // 1. quantize q: lane l of warp 0 packs dims 4l..4l+3 into one word
  if (warp == 0) {
    const float qs = decode::quantize_q_vec(qv, q8s);
    if (lane == 0) qs_shared = qs;
  }
  __syncthreads();

  // item `it` into its stage, by the warp it % kWarps: the chunk's runs of
  // consecutive slots from ballots, one bulk copy each
  auto issue = [&](int it) {
    const int st = it & (stages - 1);
    const bool is_v = it >= nloc;
    const int base = (rank + (is_v ? it - nloc : it) * C) * kRows;
    const int len = min(kRows, n - base);
    const int8_t* src = is_v ? vrows : krows;
    uint8_t* dst = ring + st * kStageBytes;
    if (lane == 0)
      sm90::mbar_arrive_expect_tx(&full[st], (uint32_t)(len * kD));
    for (int r0 = 0; r0 < len; r0 += 32) {
      const int l = r0 + lane;
      const int pos = l < len ? list[base + l] : -2;
      const int prev = __shfl_up_sync(0xffffffffu, pos, 1);
      unsigned starts = __ballot_sync(
          0xffffffffu, l < len && (lane == 0 || pos != prev + 1));
      while (starts) {
        const int a = __ffs(starts) - 1;
        starts &= starts - 1;
        const int e = starts ? __ffs(starts) - 1 : min(32, len - r0);
        const int first = __shfl_sync(0xffffffffu, pos, a);
        if (lane == 0)
          sm90::bulk_load(dst + (r0 + a) * kD, src + (size_t)first * kD,
                          (uint32_t)((e - a) * kD), &full[st]);
      }
    }
  };
  // every warp releases item `it` (a stage that is not refilled is not
  // released); the warp of item it + stages then refills the stage
  auto release = [&](int it) {
    if (it + stages >= items) return;
    const int st = it & (stages - 1);
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
    if (warp == (it + stages) % kWarps) {
      sm90::mbar_wait(&empty[st], (it >> lg_stages) & 1);
      issue(it + stages);
    }
  };
  for (int it = warp; it < min(items, stages); it += kWarps) issue(it);
  const float qscale = __fmul_rn(qs_shared, scale);
  if (bulk) sm90::mbar_wait(&bar_sc, 0);

  // 2. scores of this CTA's chunks: 8 lanes a key row (a 16-byte slice
  // each), 4 rows a warp, 32 rows a pass
  const int sub = lane & 7;
  const uint4 qw = make_uint4(q8s[4 * sub], q8s[4 * sub + 1],
                              q8s[4 * sub + 2], q8s[4 * sub + 3]);
  float local_max = neg_inf();
  for (int c = 0; c < nloc; ++c) {
    const int st = c & (stages - 1);
    sm90::mbar_wait(&full[st], (c >> lg_stages) & 1);
    const int base = (rank + c * C) * kRows;
    const int len = min(kRows, n - base);
#pragma unroll
    for (int r0 = 0; r0 < kRows; r0 += 32) {
      const int row = r0 + 4 * warp + (lane >> 3);
      int dot = 0;
      if (row < len)
        dot = decode::dot16(
            *reinterpret_cast<const uint4*>(ring + st * kStageBytes
                                            + row * kD + 16 * sub), qw);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      if (row < len && sub == 0) {
        const int pos = list[base + row];
        const float s = __fadd_rn(
            __fmul_rn(__fmul_rn((float)dot, qscale), sk[pos]), sb[pos]);
        sb[pos] = s;
        local_max = fmaxf(local_max, s);
      }
    }
    release(c);
  }

  // the global max, the max of the CTAs' (exact): lane r of warp 0 pushes
  // this CTA's into slot [rank] of rank r
  const float m_loc = decode::block_max<kWarps>(local_max, red);
  sm90::cluster_wait();
  if (warp == 0 && lane < C)
    sm90::st_async_f32(sm90::map_rank(&x_m[rank], lane), m_loc,
                       sm90::map_rank(&bar_m, lane));
  sm90::mbar_wait(&bar_m, 0);
  float m = x_m[0];
  for (int r = 1; r < C; ++r) m = fmaxf(m, x_m[r]);

  // 3-4. exp against the global m, the partial denominator, ps, its max
  float dsum = 0.0f, rmax = 0.0f;
  for (int idx = tid; idx < nloc * kRows; idx += kThreads) {
    const int li = (rank + idx / kRows * C) * kRows + idx % kRows;
    if (li >= n) continue;
    const int pos = list[li];
    const float p = expf(__fsub_rn(sb[pos], m));
    dsum += p;
    const float ps = __fmul_rn(p, sv[pos]);
    sb[pos] = ps;
    rmax = fmaxf(rmax, ps);
  }
  // the CTA's sum and max of ps, in one block reduction
  dsum = decode::warp_sum(dsum);
  rmax = decode::warp_max(rmax);
  if (lane == 0) {
    red[warp] = dsum;
    red2[warp] = rmax;
  }
  __syncthreads();
  const float d_loc = decode::warp_sum(lane < kWarps ? red[lane] : 0.0f);
  const float r_loc = decode::warp_max(lane < kWarps ? red2[lane] : 0.0f);
  if (warp == 0 && lane < C) {
    const uint32_t bar = sm90::map_rank(&bar_r, lane);
    sm90::st_async_f32(sm90::map_rank(&x_sum[rank], lane), d_loc, bar);
    sm90::st_async_f32(sm90::map_rank(&x_r[rank], lane), r_loc, bar);
  }
  sm90::mbar_wait(&bar_r, 0);
  float denom = 0.0f, rq = 0.0f;
  for (int r = 0; r < C; ++r) {           // rank order: deterministic
    denom += x_sum[r];
    rq = fmaxf(rq, x_r[r]);
  }
  rq = rq > 0.0f ? rq / 127.0f : 1.0f;
  for (int idx = tid; idx < nloc * kRows; idx += kThreads) {
    const int li = (rank + idx / kRows * C) * kRows + idx % kRows;
    if (li < n) p8[li] = (int8_t)(int)rintf(sb[list[li]] / rq);
  }
  __syncthreads();

  // 5. p . v in int32: lane l owns dims 4l..4l+3, warp w rows 4w..4w+3 of
  // each 32; the 4 x 4 bytes of 4 rows transposed into one word a dim,
  // each a dp4a against the 4 rows' p8 (rows past the chunk's end masked)
  int acc[4] = {0, 0, 0, 0};
  for (int c = 0; c < nloc; ++c) {
    const int it = nloc + c;
    const int st = it & (stages - 1);
    sm90::mbar_wait(&full[st], (it >> lg_stages) & 1);
    const int base = (rank + c * C) * kRows;
    const int len = min(kRows, n - base);
#pragma unroll
    for (int r0 = 0; r0 < kRows; r0 += 32) {
      const int row = r0 + 4 * warp;
      if (row < len) {
        int pw = *reinterpret_cast<const int*>(p8 + base + row);
        if (len - row < 4) pw &= (1 << (8 * (len - row))) - 1;
        const uint8_t* vr = ring + st * kStageBytes + row * kD + 4 * lane;
        const uint32_t a = *reinterpret_cast<const uint32_t*>(vr);
        const uint32_t bb = *reinterpret_cast<const uint32_t*>(vr + kD);
        const uint32_t cc = *reinterpret_cast<const uint32_t*>(vr + 2 * kD);
        const uint32_t dd = *reinterpret_cast<const uint32_t*>(vr + 3 * kD);
        const uint32_t ab_lo = __byte_perm(a, bb, 0x5140);   // a0 b0 a1 b1
        const uint32_t cd_lo = __byte_perm(cc, dd, 0x5140);
        const uint32_t ab_hi = __byte_perm(a, bb, 0x7362);   // a2 b2 a3 b3
        const uint32_t cd_hi = __byte_perm(cc, dd, 0x7362);
        acc[0] = __dp4a((int)__byte_perm(ab_lo, cd_lo, 0x5410), pw, acc[0]);
        acc[1] = __dp4a((int)__byte_perm(ab_lo, cd_lo, 0x7632), pw, acc[1]);
        acc[2] = __dp4a((int)__byte_perm(ab_hi, cd_hi, 0x5410), pw, acc[2]);
        acc[3] = __dp4a((int)__byte_perm(ab_hi, cd_hi, 0x7632), pw, acc[3]);
      }
    }
    release(it);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) red_o[warp][4 * lane + k] = acc[k];
  __syncthreads();
  // the int32 partials to rank 0, which adds them in rank order (exact)
  if (tid < kD) {
    int o = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) o += red_o[wi][tid];
    sm90::st_async_s32(sm90::map_rank(&x_o[rank][tid], 0), o,
                       sm90::map_rank(&bar_o, 0));
  }
  if (rank == 0 && tid < kD) {
    sm90::mbar_wait(&bar_o, 0);
    int o = 0;
    for (int r = 0; r < C; ++r) o += x_o[r][tid];
    out[(size_t)bh * kD + tid] =
        __fmul_rn((float)o, rq / fmaxf(denom, 1e-30f));
  }
}

}  // namespace

// q (B, H, 1, 128) f32; k8/v8 (B, H, S, 128) int8; ks/vs (B, H, S) f32;
// bias (B, 1, 1, S) f32; out (B, H, 1, 128) f32, all contiguous, k8 and v8
// 16-byte aligned.  C: the CTAs of a (b, h)'s cluster, 1..8; stages: the
// ring's 64-row stages, a power of two in 2..16.
// Returns a CUDA error code (0 = launched).
extern "C" int groma_int8_decode_attention(const void* q, const void* k8,
                                           const void* ks, const void* v8,
                                           const void* vs, const void* bias,
                                           void* out, int B, int H, int S,
                                           int D, int C, int stages,
                                           void* stream) {
  int lg = 1;
  while ((1 << lg) < stages) ++lg;
  if (D != kD || S < 1 || S > kMaxS || B < 1 || H < 1 || C < 1
      || C > kMaxCluster || stages != (1 << lg) || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  return sm90::launch_cluster(
      int8_decode_attention_kernel, B * H * C, kThreads,
      (size_t)smem_bytes(S, stages), (size_t)smem_bytes(kMaxS, kMaxStages),
      C, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const float*>(vs), static_cast<const float*>(bias),
      static_cast<float*>(out), H, S, C, lg, (float)(1.0 / sqrt((double)kD)));
}
