// The whole L-layer int4 + int8-KV LLaMA decode step in one launch, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel groma_tpu/ops/decode_megakernel.py `_make_kernel`
// (entry `fused_decode_step`), one pallas_call with grid=(L,).  For each
// layer l, with x the f32 residual (B rows of D = 128 H, B <= 8):
//   1. h = bf16(rms(x) * ln1[l]); qkv = h @ Wqkv[l] (f32)
//   2. per (b, head): RoPE on the f32 q and k; q, k and v quantized to int8
//      per row (IEEE division by 127); attention over the int8 cache's old
//      positions plus this token, the softmax in f32, the v scale folded
//      into p, p requantized to int8, int32 p.v (this token's term added
//      before the f32 cast), times r / max(denom, 1e-30); then this token's
//      k and v written into the cache at the scalar slot `pos`;
//   3. x += bf16(attn) @ Wo[l]
//   4. h = bf16(rms(x) * ln2[l]); act = bf16(silu(g) * u), [g | u] = h @ Wgu[l]
//   5. x += act @ Wdown[l]
// The int4 products are those of int4_matmul.cu (biased nibbles unpacked
// to exact floats, times the block's scale, f32 sums).  The TPU kernel
// folds the same sum as x @ n - 8 sum(x) per 256-row block and scales after
// the dot; the two differ only in f32 rounding.  The numerics are the TPU
// megakernel's: the residual stays f32 across the layers.
//
// Design: one persistent cooperative kernel (cudaLaunchCooperativeKernel,
// as many blocks as are co-resident, so a grid that is too large is
// refused, never deadlocked), with a grid-wide barrier between the five
// dependent phases of each layer.  Inside a phase, blocks walk its work
// items: 32-column strips of a matmul (the block's 256 threads, two column
// groups of 16 times 128 packed-row lanes, stream the strip's K/2 packed
// rows once; all B rows at a time, so every weight byte is read once a
// step), or one (b, head) of attention.  Phases 1 and 4 each recompute the
// rms of all B rows in every block that has strips to do, into shared
// memory (8 x D bf16, 64 KB at D = 4096), which saves a barrier.  The
// inputs of phases 3 and 5 (attn, 8 x D bf16; act, 8 x F bf16, 176 KB at
// F = 11008) are not staged: the strip reads them from L2, where every
// block finds them.  Buffers written inside the launch (x, qkv, attn, act)
// are read with ld.global.cg, past the SM's L1, which is not coherent
// across SMs; the weights, the scales and the cache, which no other block
// writes during the launch, go through the read-only path.  Attention reads
// the cache before this step's column is written (by the same block): a row
// whose token and old positions are all masked takes p = 1 at every one of
// the S positions, as the TPU kernel does, and walks all S; any other row
// walks the positions before `pos` only, since those after it get p = 0
// exactly.  A gate strip and its up strip (columns j and F + j) are done by
// one block, so silu(g) * u is formed there.
//
// What bounds it: at B = 8 the weights, 0.5 byte each read once (3.3 GB a
// step at the Vicuna-7B width) and the KV cache up to pos; the unpack and
// the 8 FMAs a weight make the strip ALU-heavy, as int4_matmul.cu's decode
// tile is.  This first version is correct and simple; it spends 5 L grid
// barriers a step and leaves the tensor cores idle.
// Plain version and wrapper: groma_tpu_torch/ops/decode_megakernel.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using decode::load16;
using decode::neg_inf;
using decode::nib4_to_float;
using decode::sbyte;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 8;                      // rows of the matmul tile
constexpr int kHD = 128;                    // head dim
constexpr int kScaleBlock = 256;            // K rows per scale row
constexpr int kChunk = 128;                 // packed rows with fixed scales
constexpr int kStrip = 32;                  // columns of a matmul work item
constexpr int kColGroups = kStrip / 16;     // 16 columns a thread
constexpr int kRowLanes = kThreads / kColGroups;
constexpr float kNeg = -1e30f;
static_assert(kRowLanes == kChunk, "one packed row a thread per chunk");
static_assert(kMT * kStrip == kThreads, "one strip output a thread");

struct Params {
  const float* x0;                 // (B, D) the hidden state after embedding
  float* x;                        // (B, D) the f32 residual, the output
  const float* cos;                // (B, 128) RoPE rows at this position
  const float* sin;
  const float* mask;               // (B, S) bias over the old positions
  const float* cur;                // (B,) bias of this token
  const float* ln1;                // (L, D)
  const float* ln2;
  const unsigned long long* wtab;  // (L, 8): wqkv sqkv wo so wgu sgu wdn sdn
  const unsigned long long* ctab;  // (L, 4): k8 ks v8 vs
  float* qkv;                      // (B, 3 D) scratch
  bf16* attn;                      // (B, D) scratch
  bf16* act;                       // (B, F) scratch
  int L, B, H, S, F, pos;
  float eps, scale;
};

struct Shared {
  float red[kWarps * kMT * kStrip];     // a strip's partial sums
  float out[kMT * kStrip];              // a strip's result, [m][c]
  float gate[kMT * kStrip];             // the gate strip beside its up strip
  float rs[kMT];                        // 1 / rms of each row
  __align__(16) float qf[kHD];          // this (b, head): roped q and k, v
  __align__(16) float kf[kHD];
  __align__(16) float vf[kHD];
  uint32_t q8[kHD / 4], k8[kHD / 4], v8[kHD / 4];
  float qs, ks, vs, s_cur;
  float bred[kWarps];
  int red_o[kWarps][kHD];               // p.v partial sums
};

__device__ __forceinline__ float ld_l2(const float* p) { return __ldcg(p); }

__device__ __forceinline__ float ld_l2(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ const uint8_t* as_u8(unsigned long long a) {
  return reinterpret_cast<const uint8_t*>(a);
}

__device__ __forceinline__ const float* as_f32(unsigned long long a) {
  return reinterpret_cast<const float*>(a);
}

// h[m][i] = bf16(x[m][i] / rms(x[m]) * g[i]) for m < B, 0 for pad rows.
__device__ void rms_rows(const float* x, const float* g, int B, int D,
                         float eps, bf16* h, Shared& sh) {
  const int tid = threadIdx.x;
  for (int m = 0; m < B; ++m) {
    float ss = 0.0f;
    for (int i = tid; i < D; i += kThreads) {
      const float v = ld_l2(x + (size_t)m * D + i);
      ss = fmaf(v, v, ss);
    }
    ss = decode::block_sum<kWarps>(ss, sh.bred);
    if (tid == 0)
      sh.rs[m] = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)D), eps));
  }
  __syncthreads();
  for (int i = tid; i < D; i += kThreads) {
    const float gi = __ldg(g + i);
#pragma unroll
    for (int m = 0; m < kMT; ++m)
      h[(size_t)m * D + i] = __float2bfloat16(
          m < B ? __fmul_rn(__fmul_rn(ld_l2(x + (size_t)m * D + i),
                                      sh.rs[m]), gi)
                : 0.0f);
  }
  __syncthreads();
}

// sh.out[m * 32 + c] = sum_k x[m][k] w[k][col0 + c], for the 32 columns at
// col0 of the packed (K/2, N) int4 matrix with (K/256, N) scales; pad rows
// m >= B give 0.  The x rows (K bf16 each) lie in shared memory (kShared)
// or in device memory written earlier in this launch (read through L2).
template <bool kShared>
__device__ void strip_dot(const bf16* x, int B, int K,
                          const uint8_t* __restrict__ w,
                          const float* __restrict__ scale, int N, int col0,
                          Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgi = tid % kColGroups, rl = tid / kColGroups;
  const int col = col0 + cgi * 16;
  const int kh = K / 2;
  float acc[kMT][16];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.0f;

  for (int c = 0; c < kh; c += kChunk) {
    const int r = c + rl;
    float s_lo[16], s_hi[16];
    load16(scale + (size_t)(c / kScaleBlock) * N + col, s_lo);
    load16(scale + (size_t)((c + kh) / kScaleBlock) * N + col, s_hi);
    const uint4 p = __ldg(reinterpret_cast<const uint4*>(
        w + (size_t)r * N + col));
    float xl[kMT], xh[kMT];
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const bf16* row = x + (size_t)m * K;
      xl[m] = m < B ? (kShared ? __bfloat162float(row[r]) : ld_l2(row + r))
                    : 0.0f;
      xh[m] = m < B ? (kShared ? __bfloat162float(row[kh + r])
                               : ld_l2(row + kh + r))
                    : 0.0f;
    }
    const uint32_t words[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      float f[4];
      nib4_to_float(words[wi] & 0x0F0F0F0Fu, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float wv = f[e] * s_lo[4 * wi + e];
#pragma unroll
        for (int m = 0; m < kMT; ++m)
          acc[m][4 * wi + e] = fmaf(xl[m], wv, acc[m][4 * wi + e]);
      }
      nib4_to_float((words[wi] >> 4) & 0x0F0F0F0Fu, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float wv = f[e] * s_hi[4 * wi + e];
#pragma unroll
        for (int m = 0; m < kMT; ++m)
          acc[m][4 * wi + e] = fmaf(xh[m], wv, acc[m][4 * wi + e]);
      }
    }
  }

  // lanes of one column group differ in bits 1..4 of the lane id
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  if (lane < kColGroups) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        sh.red[(warp * kMT + m) * kStrip + cgi * 16 + j] = acc[m][j];
  }
  __syncthreads();
  {
    const int m = tid / kStrip, c = tid % kStrip;
    float s = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += sh.red[(wi * kMT + m) * kStrip + c];
    sh.out[tid] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t qbyte(float x, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.0f), 127.0f);
  return (uint32_t)((int)q & 0xff);
}

// One warp quantizes a 128-wide row symmetrically: lane l packs values
// 4l..4l+3 into q8[l]; returns the scale max|x| / 127 (1 for a zero row).
__device__ __forceinline__ float quant_row(const float* x, uint32_t* q8) {
  const int lane = threadIdx.x & 31;
  const float4 v = reinterpret_cast<const float4*>(x)[lane];
  const float a = decode::warp_max(fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                                         fmaxf(fabsf(v.z), fabsf(v.w))));
  const float s = a > 0.0f ? __fdiv_rn(a, 127.0f) : 1.0f;
  q8[lane] = qbyte(v.x, s) | (qbyte(v.y, s) << 8) | (qbyte(v.z, s) << 16) |
             (qbyte(v.w, s) << 24);
  return s;
}

// Phase 2 for one (b, head) of layer l: `scores` (S floats) and `p8` (S
// bytes) are the block's shared scratch.
__device__ void attend(const Params& p, int l, int b, int h, float* scores,
                       int8_t* p8, Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = p.H * kHD, S = p.S, pos = p.pos;
  const unsigned long long* ct = p.ctab + 4 * l;
  int8_t* k8 = reinterpret_cast<int8_t*>(ct[0]);
  float* ks = reinterpret_cast<float*>(ct[1]);
  int8_t* v8 = reinterpret_cast<int8_t*>(ct[2]);
  float* vs = reinterpret_cast<float*>(ct[3]);
  const size_t bh = (size_t)b * p.H + h;
  const int8_t* krows = k8 + bh * S * kHD;
  const int8_t* vrows = v8 + bh * S * kHD;
  const float* ksr = ks + bh * S;
  const float* vsr = vs + bh * S;
  const float* mrow = p.mask + (size_t)b * S;

  // 1. RoPE (half rotation) on the f32 q and k; v as it is
  if (tid < kHD) {
    const float* row = p.qkv + (size_t)b * 3 * D + h * kHD;
    const int i = tid, half = kHD / 2;
    const float c = __ldg(p.cos + b * kHD + i), s = __ldg(p.sin + b * kHD + i);
    const int o = i < half ? i + half : i - half;
    const float sign = i < half ? -1.0f : 1.0f;
    sh.qf[i] = __fadd_rn(__fmul_rn(ld_l2(row + i), c),
                         __fmul_rn(sign * ld_l2(row + o), s));
    sh.kf[i] = __fadd_rn(__fmul_rn(ld_l2(row + D + i), c),
                         __fmul_rn(sign * ld_l2(row + D + o), s));
    sh.vf[i] = ld_l2(row + 2 * D + i);
  }
  __syncthreads();
  // 2. q, k and v quantized per row, one warp each
  if (warp < 3) {
    const float* src = warp == 0 ? sh.qf : warp == 1 ? sh.kf : sh.vf;
    uint32_t* dst = warp == 0 ? sh.q8 : warp == 1 ? sh.k8 : sh.v8;
    const float s = quant_row(src, dst);
    if (lane == 0) *(warp == 0 ? &sh.qs : warp == 1 ? &sh.ks : &sh.vs) = s;
  }
  __syncthreads();
  const float qscale = __fmul_rn(sh.qs, p.scale);
  const float cur = __ldg(p.cur + b);
  // 3. this token's score
  if (warp == 0) {
    int dot = __dp4a((int)sh.q8[lane], (int)sh.k8[lane], 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0)
      sh.s_cur = __fadd_rn(__fmul_rn(__fmul_rn((float)dot, qscale), sh.ks),
                           cur);
  }
  // 4. the old positions' scores: 8 lanes a 128-byte key row, 4 rows a
  //    warp; all S of them when this token is masked too, else those
  //    before pos
  const int n = cur > 0.5f * kNeg ? pos : S;
  const int sub = lane & 7, row_in_warp = lane >> 3;
  const uint4 qw = make_uint4(sh.q8[4 * sub], sh.q8[4 * sub + 1],
                              sh.q8[4 * sub + 2], sh.q8[4 * sub + 3]);
  float local_max = neg_inf();
  for (int base = warp * 4; base < n; base += kWarps * 4) {
    const int j = base + row_in_warp;
    int dot = 0;
    if (j < n) {
      const uint4 kw = __ldg(reinterpret_cast<const uint4*>(
                                 krows + (size_t)j * kHD) + sub);
      dot = decode::dot16(kw, qw);
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 4);
    if (j < n && sub == 0) {
      const float s = __fadd_rn(
          __fmul_rn(__fmul_rn((float)dot, qscale), __ldg(ksr + j)),
          __ldg(mrow + j));
      scores[j] = s;
      local_max = fmaxf(local_max, s);
    }
  }
  const float m = fmaxf(decode::block_max<kWarps>(local_max, sh.bred),
                        sh.s_cur);

  // 5. exp, the denominator, the v scale folded into p, p requantized
  float dsum = 0.0f, rmax = 0.0f;
  for (int j = tid; j < n; j += kThreads) {
    const float pj = expf(__fsub_rn(scores[j], m));
    dsum += pj;
    const float ps = __fmul_rn(pj, __ldg(vsr + j));
    scores[j] = ps;
    rmax = fmaxf(rmax, ps);
  }
  const float p_cur = expf(__fsub_rn(sh.s_cur, m));
  const float denom = __fadd_rn(decode::block_sum<kWarps>(dsum, sh.bred),
                                p_cur);
  const float ps_cur = __fmul_rn(p_cur, sh.vs);
  float r = fmaxf(decode::block_max<kWarps>(rmax, sh.bred), ps_cur);
  r = r > 0.0f ? __fdiv_rn(r, 127.0f) : 1.0f;
  for (int j = tid; j < n; j += kThreads)
    p8[j] = (int8_t)(int)rintf(__fdiv_rn(scores[j], r));
  const int p8c = (int)rintf(__fdiv_rn(ps_cur, r));
  __syncthreads();

  // 6. p.v in int32: a thread owns 16 dims of one position a step
  const int dg = tid & 7;
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  for (int j = tid >> 3; j < n; j += kThreads / 8) {
    const uint4 vw = __ldg(reinterpret_cast<const uint4*>(
                               vrows + (size_t)j * kHD) + dg);
    const int pj = p8[j];
    const uint32_t words[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
    for (int wi = 0; wi < 4; ++wi)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * wi + i] += pj * sbyte(words[wi], i);
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
    for (int j = 0; j < 16; ++j) sh.red_o[warp][dg * 16 + j] = acc[j];
  }
  __syncthreads();
  if (tid < kHD) {
    int o = p8c * sbyte(sh.v8[tid / 4], tid % 4);
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) o += sh.red_o[wi][tid];
    const float val = __fmul_rn((float)o,
                                __fdiv_rn(r, fmaxf(denom, 1e-30f)));
    p.attn[(size_t)b * D + h * kHD + tid] = __float2bfloat16(val);
  }
  // 7. this token's k and v into the cache at pos
  if (tid < kHD / 4) {
    reinterpret_cast<uint32_t*>(k8 + (bh * S + pos) * kHD)[tid] = sh.k8[tid];
    reinterpret_cast<uint32_t*>(v8 + (bh * S + pos) * kHD)[tid] = sh.v8[tid];
  }
  if (tid == 0) {
    ks[bh * S + pos] = sh.ks;
    vs[bh * S + pos] = sh.vs;
  }
  __syncthreads();                // the next item reuses the shared scratch
}

__global__ void __launch_bounds__(kThreads, 1)
decode_megakernel(Params p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared sh;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int B = p.B, D = p.H * kHD, F = p.F;
  bf16* h = reinterpret_cast<bf16*>(dyn);                 // phases 1 and 4
  float* scores = reinterpret_cast<float*>(dyn);          // phase 2
  int8_t* p8 = reinterpret_cast<int8_t*>(scores + p.S);
  const int m = tid / kStrip, c = tid % kStrip;           // a strip output

  for (int l = 0; l < p.L; ++l) {
    const unsigned long long* wt = p.wtab + 8 * l;
    const float* xin = l == 0 ? p.x0 : p.x;

    // 1. rms1, then the fused qkv projection
    const int n_qkv = 3 * D / kStrip;
    if ((int)blockIdx.x < n_qkv) {
      rms_rows(xin, p.ln1 + (size_t)l * D, B, D, p.eps, h, sh);
      for (int it = blockIdx.x; it < n_qkv; it += gridDim.x) {
        strip_dot<true>(h, B, D, as_u8(wt[0]), as_f32(wt[1]), 3 * D,
                        it * kStrip, sh);
        if (m < B) p.qkv[(size_t)m * 3 * D + it * kStrip + c] = sh.out[tid];
      }
    }
    grid.sync();

    // 2. attention, one (b, head) an item
    for (int it = blockIdx.x; it < B * p.H; it += gridDim.x)
      attend(p, l, it / p.H, it % p.H, scores, p8, sh);
    grid.sync();

    // 3. o projection and the residual
    for (int it = blockIdx.x; it < D / kStrip; it += gridDim.x) {
      strip_dot<false>(p.attn, B, D, as_u8(wt[2]), as_f32(wt[3]), D,
                       it * kStrip, sh);
      if (m < B) {
        const size_t i = (size_t)m * D + it * kStrip + c;
        p.x[i] = __fadd_rn(ld_l2(xin + i), sh.out[tid]);
      }
    }
    grid.sync();

    // 4. rms2, gate and up (columns j and F + j together), silu(g) * u
    const int n_gu = F / kStrip;
    if ((int)blockIdx.x < n_gu) {
      rms_rows(p.x, p.ln2 + (size_t)l * D, B, D, p.eps, h, sh);
      for (int it = blockIdx.x; it < n_gu; it += gridDim.x) {
        strip_dot<true>(h, B, D, as_u8(wt[4]), as_f32(wt[5]), 2 * F,
                        it * kStrip, sh);
        sh.gate[tid] = sh.out[tid];
        strip_dot<true>(h, B, D, as_u8(wt[4]), as_f32(wt[5]), 2 * F,
                        F + it * kStrip, sh);
        if (m < B) {
          const float g = sh.gate[tid];
          const float silu = __fdiv_rn(g, __fadd_rn(1.0f, expf(-g)));
          p.act[(size_t)m * F + it * kStrip + c] =
              __float2bfloat16(__fmul_rn(silu, sh.out[tid]));
        }
      }
    }
    grid.sync();

    // 5. down projection and the residual
    for (int it = blockIdx.x; it < D / kStrip; it += gridDim.x) {
      strip_dot<false>(p.act, B, F, as_u8(wt[6]), as_f32(wt[7]), D,
                       it * kStrip, sh);
      if (m < B) {
        const size_t i = (size_t)m * D + it * kStrip + c;
        p.x[i] = __fadd_rn(ld_l2(p.x + i), sh.out[tid]);
      }
    }
    grid.sync();
  }
}

size_t dynamic_smem(int D, int S) {
  const size_t rows = (size_t)kMT * D * sizeof(bf16);
  const size_t attn = (size_t)S * (sizeof(float) + 1);
  return rows > attn ? rows : attn;
}

// Blocks per SM that can be co-resident, or a negative CUDA error.
int blocks_per_sm(size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      decode_megakernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_megakernel,
                                                    kThreads, smem);
  return e != cudaSuccess ? -(int)e : per_sm;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

// x0/x (B, D) f32; cos/sin (B, 128) f32; mask (B, S) f32; cur (B,) f32;
// ln1/ln2 (L, D) f32; wtab (L, 8) and ctab (L, 4) device tables of the
// per-layer weight and cache addresses (packed (K/2, N) uint8 with
// (K/256, N) f32 scales; (B, H, S, 128) int8 with (B, H, S) f32 scales);
// qkv (B, 3 D) f32, attn (B, D) bf16, act (B, F) bf16 scratch; all
// contiguous.  B <= 8, D = 128 H and F multiples of 256, 0 <= pos < S.
// Returns the launch's CUDA status (0 = launched): a grid that cannot be
// co-resident is refused.  *blocks receives the grid it launched.
extern "C" int groma_decode_megakernel(
    const void* x0, void* x, const void* cos, const void* sin,
    const void* mask, const void* cur, const void* ln1, const void* ln2,
    const void* wtab, const void* ctab, void* qkv, void* attn, void* act,
    int L, int B, int H, int S, int F, int pos, float eps, int* blocks,
    void* stream) {
  const int D = H * kHD;
  if (L < 1 || B < 1 || B > kMT || H < 1 || S < 1 || pos < 0 || pos >= S ||
      D % kScaleBlock || F < kScaleBlock || F % kScaleBlock)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x0 = static_cast<const float*>(x0);
  p.x = static_cast<float*>(x);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.mask = static_cast<const float*>(mask);
  p.cur = static_cast<const float*>(cur);
  p.ln1 = static_cast<const float*>(ln1);
  p.ln2 = static_cast<const float*>(ln2);
  p.wtab = static_cast<const unsigned long long*>(wtab);
  p.ctab = static_cast<const unsigned long long*>(ctab);
  p.qkv = static_cast<float*>(qkv);
  p.attn = static_cast<bf16*>(attn);
  p.act = static_cast<bf16*>(act);
  p.L = L;
  p.B = B;
  p.H = H;
  p.S = S;
  p.F = F;
  p.pos = pos;
  p.eps = eps;
  p.scale = (float)(1.0 / sqrt((double)kHD));
  const size_t smem = dynamic_smem(D, S);
  const int per_sm = blocks_per_sm(smem);
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  *blocks = per_sm * sm_count();
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)decode_megakernel, dim3(*blocks), dim3(kThreads), args,
      smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
