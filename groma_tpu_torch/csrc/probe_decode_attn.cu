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
// Grid: x = (b, group of HB heads) processed one head after another (HB =
// 1 is #2's first grid, one block per (b, head)), y = S block, z = layer
// (one launch for L independent layers, the TPU's `Lstack`; q and the bias
// are shared by the layers, as the TPU probe broadcasts them).
//
// What bounds it: the KV bytes, 2 S D int8 + 8 S of scales per (b, h) (B=8,
// H=32, S=1024: 69 MB a layer, 20.7 us at 3.35 TB/s).  So the KV rows are
// fed as #2 (decode_attention.cu) feeds them, and each structure's time is
// that of its grid and body, not of its loads:
// - a (b, h) row's K and V are contiguous (S x 128 bytes); they stream
//   through a ring of 64-row stages (8 KB each) filled by 1-d
//   `cp.async.bulk` copies that complete on mbarriers.  One producer thread
//   (a warp of its own) fills the ring: for each head of the block in
//   order, its K stages, then its V stages, with no drain between heads;
//   a stage is refilled once the eight consumer warps released it, each
//   after fence.proxy.async, since they read it with ld.shared.  So V is
//   in flight while the mxu bodies take the max, the exponentials and the
//   requantization of p; the floor body streams K and V back to back;
// - the row's ks and vs (and, once a block, the bias) come in one bulk
//   copy each, on barriers of their own, into one of `nbuf` scale buffers
//   (two where they fit: the next head's arrive during this one); so S and
//   the S block are multiples of 4 (16-byte copies);
// - the scores, the exponentials and the int32 p . v dots read shared
//   memory, in #2's order and roundings (rintf, __fmul_rn chains), as the
//   first version of this probe, which read device memory per thread;
// - the host's `ring_plan` (exp_decode_attn_variants.py) sizes the ring
//   (2 to 4 stages: deeper rings were no faster) and the scale buffers so
//   that two blocks of 288 threads fit an SM; at S = 4096 a block stays
//   under 227 KB.
// Plain versions, plan and wrapper:
// groma_tpu_torch/benchmarks/exp_decode_attn_variants.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "sm90_common.cuh"

namespace {

using decode::neg_inf;
using decode::sbyte;

constexpr int kWarps = 8;                  // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer's warp
constexpr int kD = 128;
constexpr int kRows = 64;                  // rows of a stage
constexpr int kStageBytes = kRows * kD;    // 8 KB
constexpr int kMaxStages = 4;
constexpr int kPosLanes = kConsumers / 8;  // rows a pass of the p.v loop
constexpr int kMaxS = 4096;

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
  int B, H, S, sblk, stages, nbuf;
  float scale;
};

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int pad16(int x) { return (x + 15) & ~15; }

// dynamic shared memory: the ring; nbuf x (ks, vs) of the S block; for
// the mxu bodies the bias, the scores (later ps) and p8 of the S block
__host__ __device__ constexpr int smem_bytes(int body, int sblk, int stages,
                                             int nbuf) {
  return stages * kStageBytes + nbuf * 8 * pad4(sblk)
         + (body ? 8 * pad4(sblk) + pad16(sblk) : 0);
}

// the consumers' barrier (the producer warp never joins)
__device__ __forceinline__ void csync() { sm90::named_sync(1, kConsumers); }

__device__ float cmax(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = decode::warp_max(v);
  if (lane == 0) red[warp] = v;
  csync();
  v = decode::warp_max(lane < kWarps ? red[lane] : neg_inf());
  csync();
  return v;
}

__device__ float csum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = decode::warp_sum(v);
  if (lane == 0) red[warp] = v;
  csync();
  v = decode::warp_sum(lane < kWarps ? red[lane] : 0.0f);
  csync();
  return v;
}

// acc[16] of every consumer -> red_o[warp][d]: the warp's sums (lanes
// sharing dg differ in bits 3..4 of the lane id)
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
  csync();
}

// This consumer's rows of one stage (rows `pos_lane` and `pos_lane` + 32
// of the first `len`), dims 16 dg.., summed into acc, each byte times
// p8[row] where `p8` is given, else times 1.
__device__ __forceinline__ void column_sums(const uint8_t* st, int len,
                                            int pos_lane, int dg,
                                            const int8_t* p8, int* acc) {
#pragma unroll
  for (int r = pos_lane; r < kRows; r += kPosLanes) {
    if (r >= len) break;
    const uint4 w = *reinterpret_cast<const uint4*>(st + r * kD + 16 * dg);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    const int p = p8 ? p8[r] : 1;
#pragma unroll
    for (int wi = 0; wi < 4; ++wi)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * wi + i] += p * sbyte(words[wi], i);
  }
}

template <int BODY, int HB>
__global__ void __launch_bounds__(kThreads, 2) probe_attn_kernel(Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int sp = pad4(a.sblk);
  uint8_t* ring = smem;
  float* scl = reinterpret_cast<float*>(smem + a.stages * kStageBytes);
  float* sbias = scl + a.nbuf * 2 * sp;                 // mxu bodies
  float* scores = sbias + sp;
  int8_t* p8 = reinterpret_cast<int8_t*>(scores + sp);
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ uint64_t sc_full[2], sc_empty[2], bias_full;
  __shared__ float red[kWarps];
  __shared__ uint32_t q8s[kD / 4];
  __shared__ float qs_shared;
  __shared__ int red_o[kWarps][kD];

  const int groups = a.H / HB;
  const int b = blockIdx.x / groups, hg = blockIdx.x % groups;
  const int sb = blockIdx.y, nsb = gridDim.y, layer = blockIdx.z;
  const int s0 = sb * a.sblk, n = min(a.S, s0 + a.sblk) - s0;
  const int nst = (n + kRows - 1) / kRows;          // stages of K (of V)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)layer * a.B * a.H + b * a.H + hg * HB;
  const int stages = a.stages, nbuf = a.nbuf;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWarps);           // lane 0 of each
    }
    for (int i = 0; i < nbuf; ++i) {
      sm90::mbar_init(&sc_full[i], 1);
      sm90::mbar_init(&sc_empty[i], kWarps);
    }
    sm90::mbar_init(&bias_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    // --------------------------------------------------------- producer
    if (lane != 0) return;
    if (BODY > 0) {
      sm90::mbar_arrive_expect_tx(&bias_full, 4 * n);
      sm90::bulk_load(sbias, a.bias + (size_t)b * a.S + s0, 4 * n,
                      &bias_full);
    }
    int it = 0;
    for (int hi = 0; hi < HB; ++hi) {
      const size_t row = row0 + hi;
      const int8_t* src[2] = {a.k8 + (row * a.S + s0) * kD,
                              a.v8 + (row * a.S + s0) * kD};
      // with one scale buffer, the head's scales wait for the last head
      // to end: its first K stages go first
      const int lag = hi == 0 || nbuf == 2 ? 0 : min(stages, nst);
      for (int j = 0; j < 2 * nst; ++j, ++it) {
        if (j == lag) {
          const int buf = hi % nbuf;
          float* dst = scl + buf * 2 * sp;
          sm90::mbar_wait(&sc_empty[buf], ((hi / nbuf) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&sc_full[buf], 8 * n);
          sm90::bulk_load(dst, a.ks + row * a.S + s0, 4 * n, &sc_full[buf]);
          sm90::bulk_load(dst + sp, a.vs + row * a.S + s0, 4 * n,
                          &sc_full[buf]);
        }
        const int s = it % stages, st = j % nst;
        const int len = min(kRows, n - st * kRows);
        sm90::mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], len * kD);
        sm90::bulk_load(ring + s * kStageBytes,
                        src[j / nst] + (size_t)st * kRows * kD, len * kD,
                        &full[s]);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  const int dg = tid & 7, pos_lane = tid >> 3;
  int it = 0;
  // wait for the item `it`'s stage; after reading it, release it
  auto take = [&]() -> const uint8_t* {
    const int s = it % stages;
    sm90::mbar_wait(&full[s], (it / stages) & 1);
    return ring + s * kStageBytes;
  };
  auto release = [&]() {
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[it % stages]);
    ++it;
  };
  if (BODY > 0) sm90::mbar_wait(&bias_full, 0);

  for (int hi = 0; hi < HB; ++hi) {
    const size_t row = row0 + hi;
    const int bh = b * a.H + hg * HB + hi;
    const int buf = hi % nbuf;
    const float* sks = scl + buf * 2 * sp;
    const float* svs = sks + sp;
    sm90::mbar_wait(&sc_full[buf], (hi / nbuf) & 1);
    int acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0;

    if (BODY == 0) {
      for (int j = 0; j < 2 * nst; ++j) {
        const int st = j % nst;
        column_sums(take(), min(kRows, n - st * kRows), pos_lane, dg,
                    nullptr, acc);
        release();
      }
      float sk = 0.0f, sv = 0.0f;
      for (int i = tid; i < n; i += kConsumers) {
        sk += sks[i];
        sv += svs[i];
      }
      sk = csum(sk, red);
      sv = csum(sv, red);
      reduce_columns(acc, red_o);
      if (tid < kD) {
        int t = 0;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) t += red_o[wi][tid];
        a.out[row * kD + tid] = (float)t + sk + sv + a.bias[(size_t)b * a.S];
      }
    } else {
      // 1. quantize q: lane l packs dims 4l..4l+3 into one word
      if (warp == 0) {
        const float qs = decode::quantize_q_row(a.q + (size_t)bh * kD, q8s);
        if (lane == 0) qs_shared = qs;
      }
      csync();
      const float qscale = __fmul_rn(qs_shared, a.scale);

      // 2. scores: 8 lanes per key row, each a 16-byte slice, 4 rows a
      // warp, 32 rows a pass, two passes a stage
      const int sub = lane & 7;
      const uint4 qw = make_uint4(q8s[4 * sub], q8s[4 * sub + 1],
                                  q8s[4 * sub + 2], q8s[4 * sub + 3]);
      float local_max = neg_inf();
      for (int st = 0; st < nst; ++st) {
        const uint8_t* stage = take();
        const int len = min(kRows, n - st * kRows);
#pragma unroll
        for (int r0 = 0; r0 < kRows; r0 += 32) {
          const int r = r0 + 4 * warp + (lane >> 3);
          int dot = 0;
          if (r < len)
            dot = decode::dot16(*reinterpret_cast<const uint4*>(
                                    stage + r * kD + 16 * sub), qw);
          dot += __shfl_xor_sync(0xffffffffu, dot, 1);
          dot += __shfl_xor_sync(0xffffffffu, dot, 2);
          dot += __shfl_xor_sync(0xffffffffu, dot, 4);
          const int i = st * kRows + r;
          if (r < len && sub == 0) {
            const float s = __fadd_rn(
                __fmul_rn(__fmul_rn((float)dot, qscale), sks[i]), sbias[i]);
            scores[i] = s;
            local_max = fmaxf(local_max, s);
          }
        }
        release();
      }
      const float m = cmax(local_max, red);

      // 3-4. exp, denominator, the v scale folded into p, its max
      float dsum = 0.0f, rmax = 0.0f;
      for (int i = tid; i < n; i += kConsumers) {
        const float p = expf(__fsub_rn(scores[i], m));
        dsum += p;
        const float ps = __fmul_rn(p, svs[i]);
        scores[i] = ps;
        rmax = fmaxf(rmax, ps);
      }
      const float denom = csum(dsum, red);
      float r = cmax(rmax, red);
      r = r > 0.0f ? r / 127.0f : 1.0f;
      for (int i = tid; i < n; i += kConsumers)
        p8[i] = (int8_t)(int)rintf(scores[i] / r);
      csync();

      // 5. p . v in int32: a thread owns 16 dims of two rows a stage
      for (int st = 0; st < nst; ++st) {
        column_sums(take(), min(kRows, n - st * kRows), pos_lane, dg,
                    p8 + st * kRows, acc);
        release();
      }
      reduce_columns(acc, red_o);
      if (tid < kD) {
        int o = 0;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) o += red_o[wi][tid];
        if (BODY == 1) {
          a.out[row * kD + tid] =
              __fmul_rn((float)o, r / fmaxf(denom, 1e-30f));
        } else {
          const size_t part = row * nsb + sb;
          a.o_part[part * kD + tid] = __fmul_rn((float)o, r);
          if (tid == 0) {
            a.m_part[part] = m;
            a.d_part[part] = denom;
          }
        }
      }
    }
    // the head's scales and red_o are free again
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sc_empty[buf]);
    csync();
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

template <int BODY, int HB>
int launch_kernel(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_attn_kernel<BODY, HB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  probe_attn_kernel<BODY, HB><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int BODY>
int launch_body(const Args& a, int hb, int L, cudaStream_t s) {
  const int nsb = (a.S + a.sblk - 1) / a.sblk;
  const dim3 grid(a.B * a.H / hb, nsb, L);
  const size_t smem = (size_t)smem_bytes(BODY, a.sblk, a.stages, a.nbuf);
  int err;
  switch (hb) {
    case 1: err = launch_kernel<BODY, 1>(a, grid, smem, s); break;
    case 8: err = launch_kernel<BODY, 8>(a, grid, smem, s); break;
    case 16: err = launch_kernel<BODY, 16>(a, grid, smem, s); break;
    case 32: err = launch_kernel<BODY, 32>(a, grid, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (BODY != 2 || err != 0) return err;
  probe_attn_combine<<<dim3(a.B * a.H, 1, L), kD, 0, s>>>(a, nsb);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, 1, 128) f32; k8/v8 (L, B, H, S, 128) int8, 16-byte aligned;
// ks/vs (L, B, H, S) f32 and bias (B, 1, 1, S) f32, 16-byte aligned;
// out (L, B, H, 1, 128) f32; body 0 (floor), 1 (whole-S) or 2 (S blocks
// of sblk, with partials m/d (L, B, H, nsb) and o (L, B, H, nsb, 128)
// f32); hb in {1, 8, 16, 32} dividing H; S and sblk multiples of 4, body
// 0 and 1 take sblk = S; the ring's `stages` (2..4) and scale buffers
// `nbuf` (1 or 2) from the host's `ring_plan`, within 227 KB of shared
// memory.  All contiguous.  Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int groma_probe_decode_attn(const void* q, const void* k8,
                                       const void* ks, const void* v8,
                                       const void* vs, const void* bias,
                                       void* out, void* m_part, void* d_part,
                                       void* o_part, int L, int B, int H,
                                       int S, int D, int body, int hb,
                                       int sblk, int stages, int nbuf,
                                       void* stream) {
  if (D != kD || L < 1 || B < 1 || H < 1 || hb < 1 || H % hb || S < 1
      || sblk < 1 || sblk > kMaxS || (body != 2 && sblk != S) || S % 4
      || sblk % 4 || stages < 2 || stages > kMaxStages || nbuf < 1
      || nbuf > 2 || smem_bytes(body, sblk, stages, nbuf) > 227 * 1024
      || ((reinterpret_cast<uintptr_t>(k8) | reinterpret_cast<uintptr_t>(v8)
           | reinterpret_cast<uintptr_t>(ks) | reinterpret_cast<uintptr_t>(vs)
           | reinterpret_cast<uintptr_t>(bias)) & 15))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), static_cast<const int8_t*>(k8),
         static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
         static_cast<const float*>(vs), static_cast<const float*>(bias),
         static_cast<float*>(out), static_cast<float*>(m_part),
         static_cast<float*>(d_part), static_cast<float*>(o_part),
         B, H, S, sblk, stages, nbuf,
         (float)(1.0 / sqrt((double)kD))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0: return launch_body<0>(a, hb, L, s);
    case 1: return launch_body<1>(a, hb, L, s);
    case 2: return launch_body<2>(a, hb, L, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
