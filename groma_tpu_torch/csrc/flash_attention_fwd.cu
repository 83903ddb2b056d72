// Flash-attention forward on Hopper (sm_90a): bf16 q/k/v, f32 online
// softmax, bf16 out and (on request) the f32 log-sum-exp of every row.
//
// Replaces two TPU kernels of groma_tpu/ops/flash_attention.py, one
// template instantiation each:
//   * kCausal = false: `_fwd_wholekv_kernel` (the whole kv range in one
//     VMEM block; DINOv2-L at (B, 16, 1025, 64)), Sq != Skv allowed;
//   * kCausal = true: `_fwd_kernel` over the live block pairs of
//     `_causal_pairs` (LLaMA at (B, 32, 2048, 128)): key tiles wholly above
//     the diagonal (offset Skv - Sq) are never loaded.
// Their numerics: the (B, Skv) key mask and the causal band set a score to
// exactly -1e30 before the row max; p is rounded to bf16 before p v; a row
// with no valid key gives out 0 and lse -1e30 (its p is 0 from a row test:
// exp(-1e30 - (-1e30)) would be 1).
//
// What bounds it: tensor-core work, 4 Sq Skv D flops per (b, h), halved by
// the causal skip, against 2 (2 Sq + 2 Skv) D bytes.  The design is the
// backward's (flash_attention_bwd.cu) with the queries as the M dimension:
//   * one CTA per BQ query rows of one (b, h), warp-specialised: one
//     producer thread loads the q tile once and keeps TMA loads of the k
//     and v tiles (BK keys, 128-byte swizzled; 3-d tensor maps (D, S,
//     B x H) zero-fill rows past Sq or Skv, never reading the next
//     (b, h)'s) in flight through two 2-stage mbarrier rings, one for k
//     and one for v.  setmaxnreg gives the producer warpgroup 24 registers
//     and the consumers the rest; the host refuses to launch if ptxas gave
//     fewer than that needs (setmaxnreg would wait forever);
//   * each consumer warpgroup owns 64 query rows.  s = q k^T by wgmma with
//     both operands K-major straight from the TMA tiles; the accumulator of
//     s is the A-register layout of the next product, so p (bf16) goes
//     from registers into o += p v, with v read MN-major (the transpose
//     bit): no tile is staged twice or transposed;
//   * overlap: tile j's s product is issued with tile j-1's p v, and tile
//     j's softmax runs while that p v does; o is rescaled after it.  Every
//     register write that feeds a product precedes wgmma_fence, fenced, and
//     both mbarrier waits precede the products: otherwise ptxas serializes
//     them (its -v log says so);
//   * masking: a mask row is Skv bytes, no TMA pitch, so each consumer warp
//     reads a tile's BK mask bytes with plain loads (key < Skv tested first:
//     past Skv lies the next batch row's mask) into BK / 32 ballot words.
//     A tile whose keys are all valid and wholly below the diagonal takes a
//     path with no select; only tiles that cross the diagonal test the band;
//   * edges: rows past Sq read q as zeros and are never written; causal
//     launches the longest query tiles first (blockIdx.y = 0).
// No atomics: two calls give bitwise-equal out and lse.
// Two configurations (the Cfg aliases at the end), chosen on the card:
//   * D = 128 (LLaMA): two consumer warpgroups, BQ = BK = 128, one CTA per
//     SM, 240 registers a consumer thread (o 64, s 64, p 32 packed); shared
//     memory q 32 KB + two k and two v stages of 32 KB = 160 KB.  At (2, 32,
//     2048, 128) 16 x 64 = 1024 CTAs of 16 down to 1 key tiles;
//   * D = 64 (DINOv2): one consumer warpgroup, BQ = BK = 64, three CTAs per
//     SM, 136 registers a consumer thread (o 32, s 32, p 16), 8 + 32 KB of
//     shared memory each; 128-key tiles at two CTAs per SM and four CTAs
//     per SM (spills) were slower.  At (2, 16, 1025, 64) 17
//     query tiles x 32 (b, h) = 544 CTAs over 396 slots, 1.37 waves (the
//     seventeenth tile holds one real row); two consumer warpgroups at one
//     CTA per SM made 288 CTAs, 2.18 waves, and were slower.
// Plain version and wrapper: groma_tpu_torch/ops/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;   // a masked score, exactly
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int STAGES = 2;           // depth of the k ring and of the v ring
constexpr int PRODUCER_REGS = 24;

// NWG consumer warpgroups of 64 query rows, BK keys a tile, MINB CTAs per
// SM.
template <int D_, int NWG_, int BK_, int MINB_>
struct Cfg {
  static constexpr int D = D_, NWG = NWG_, BK = BK_, MINB = MINB_;
  static constexpr int BQ = 64 * NWG;
  static constexpr int THREADS = 128 * (NWG + 1);
  // the registers a thread gets at launch, and a consumer's after the
  // producer warpgroup gives up all but PRODUCER_REGS of its own
  static constexpr int LAUNCH_REGS = (65536 / (THREADS * MINB)) & ~7;
  static constexpr int CONSUMER_REGS =
      ((LAUNCH_REGS * THREADS - 128 * PRODUCER_REGS) / (128 * NWG)) & ~7;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // one k or v tile
  // byte offsets from a 1024-aligned base (every tile 1024-aligned)
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // q's barrier, then full and empty of every k and v stage
  static constexpr size_t SMEM = OFF_BAR + (1 + 4 * STAGES) * 8 + 1024;
  static_assert(D % 64 == 0 && (BK == 64 || BK == 128), "tile shapes");
  static_assert(CONSUMER_REGS <= 256, "setmaxnreg takes at most 256");
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// s (64 x BK) = q (64 x D) k^T, both K-major: q's column blocks BQ x 128
// bytes apart, k's BK x 128.
template <class C>
__device__ __forceinline__ void qk(float* s, uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int kc = 0; kc < C::D / 16; ++kc) {
    const uint64_t da = sm90::desc(sq + (kc / 4) * C::BQ * 128
                                   + (kc % 4) * 32, 16, 1024);
    const uint64_t db = sm90::desc(sk + (kc / 4) * C::BK * 128
                                   + (kc % 4) * 32, 16, 1024);
    if constexpr (C::BK == 64) sm90::wgmma_ss_n64<0, 0>(s, da, db, kc > 0);
    else sm90::wgmma_ss_n128<0, 0>(s, da, db, kc > 0);
  }
}

// o (64 x D) += p (64 x BK, registers) v (BK x D, MN-major: k16 = 16 key
// rows, 64-column blocks BK x 128 bytes apart).
template <class C>
__device__ __forceinline__ void pv(float* o, const uint32_t (*pa)[4],
                                   uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    const uint64_t db = sm90::desc(sv + kk * 2048, C::BK * 128, 1024);
    if constexpr (C::D == 64) sm90::wgmma_rs_n64<1>(o, pa[kk], db, 1);
    else sm90::wgmma_rs_n128<1>(o, pa[kk], db, 1);
  }
}

// The tile's mask bytes: lane l holds keys k0 + 32 i + l (0 past Skv: there
// lies the next batch row's mask).
template <int BK>
__device__ __forceinline__ void load_mask(uint8_t* kv, const uint8_t* mrow,
                                          int k0, int Skv, int lane) {
#pragma unroll
  for (int i = 0; i < BK / 32; ++i) {
    const int key = k0 + 32 * i + lane;
    kv[i] = key < Skv ? __ldg(mrow + key) : 0;
  }
}

// Ballot word i, bit c: key k0 + 32 i + c valid; shifted so that bit
// 8 (j & 3) + (e & 1) of word j / 4 is this thread's element (j, e).
// Returns whether every key of the tile is valid.
template <int BK>
__device__ __forceinline__ bool ballot_mask(uint32_t* vm, const uint8_t* kv,
                                            int tq) {
  bool all_valid = true;
#pragma unroll
  for (int i = 0; i < BK / 32; ++i) {
    vm[i] = __ballot_sync(0xffffffffu, kv[i] != 0);
    all_valid &= vm[i] == 0xffffffffu;
    vm[i] >>= 2 * tq;
  }
  return all_valid;
}

// One tile's online softmax, in place: scores s -> p (log2 units; a masked
// score is exactly kNegInf before the row max); m, the row maxima, updated;
// corr, the factor for the earlier o and l; rs, this thread's part of the
// tile's row sums.  MASK 0: every key valid and visible (no select); 1: the
// key mask; 2: the key mask and the causal band (row r0 sees columns <=
// lim, row r0 + 8 columns <= lim + 8).
template <int BK, int MASK>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* corr,
                                             float* rs, const uint32_t* vm,
                                             int lim, int tq, float sl2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * jj + e] * sl2;
      if constexpr (MASK > 0) {
        const int c = 8 * jj + 2 * tq + (e & 1);
        bool ok = (vm[jj >> 2] >> (8 * (jj & 3) + (e & 1))) & 1u;
        if constexpr (MASK == 2) ok = ok && c <= lim + 8 * (e >> 1);
        x = ok ? x : kNegInf;
      }
      s[4 * jj + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    corr[i] = sm90::ex2(m[i] - mx[i]);
    m[i] = mx[i];
    live[i] = mx[i] > 0.5f * kNegInf;   // false: no valid key in the row yet
    rs[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float p = live[r] ? sm90::ex2(s[i] - m[r]) : 0.0f;
    s[i] = p;
    rs[r] += p;
  }
}

template <class C, bool kCausal>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int Skv,
                 float scale) {
  constexpr int D = C::D, BK = C::BK, BQ = C::BQ, NWG = C::NWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(base + C::OFF_BAR);
  uint64_t* full_k = q_bar + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  const int bh = blockIdx.x, b = bh / H;
  const int nq = gridDim.y;
  // causal: the longest query tiles first, so the last wave is short
  const int qt = kCausal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * BQ;
  const int off = Skv - Sq;
  int n_kv = (Skv + BK - 1) / BK;
  if (kCausal) {
    const int last = q0 + BQ - 1 + off;   // the tile's last visible key
    n_kv = min(n_kv, last >= 0 ? last / BK + 1 : 0);
  }
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    sm90::mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty_k[s], 4 * NWG);   // one lane per consumer warp
      sm90::mbar_init(&empty_v[s], 4 * NWG);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {
    // ------------------------------------------------------- producer
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid % 128 == 0 && n_kv > 0) {
      sm90::prefetch_map(&tm_q);
      sm90::prefetch_map(&tm_k);
      sm90::prefetch_map(&tm_v);
      sm90::mbar_arrive_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        sm90::tma_load_3d(base + C::OFF_Q + cb * BQ * 128, &tm_q, q_bar,
                          cb * 64, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES, par = ((j / STAGES) & 1) ^ 1;
        sm90::mbar_wait(&empty_k[s], par);
        sm90::mbar_arrive_expect_tx(&full_k[s], C::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          sm90::tma_load_3d(base + C::OFF_K + s * C::KV_BYTES
                                + cb * BK * 128,
                            &tm_k, &full_k[s], cb * 64, j * BK, bh);
        sm90::mbar_wait(&empty_v[s], par);
        sm90::mbar_arrive_expect_tx(&full_v[s], C::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          sm90::tma_load_3d(base + C::OFF_V + s * C::KV_BYTES
                                + cb * BK * 128,
                            &tm_v, &full_v[s], cb * 64, j * BK, bh);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    sm90::setmaxnreg_inc<C::CONSUMER_REGS>();
    const int t = tid % 128, warp = t / 32, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int wq0 = q0 + wg * 64;              // this warpgroup's rows
    const int r0 = wq0 + warp * 16 + g;        // this thread's: r0, r0 + 8
    const uint8_t* mrow = mask + (size_t)b * Skv;
    const float sl2 = scale * LOG2E;
    const uint32_t sQ = sm90::smem_u32(base + C::OFF_Q) + wg * 64 * 128;
    const uint32_t sK = sm90::smem_u32(base + C::OFF_K);
    const uint32_t sV = sm90::smem_u32(base + C::OFF_V);

    // accumulator element 4j + e sits at row r0 + 8 (e >> 1), column
    // 8j + 2 tq + (e & 1) of its tile
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    float s[BK / 2];
    uint32_t pa[BK / 16][4];

    // tile j: s_j = q k_j^T, issued before o += p_{j-1} v_{j-1} (but for
    // the first tile), then s_j's softmax while that product runs
    auto step = [&](int j, auto first) {
      constexpr bool kFirst = decltype(first)::value;
      const int st = j % STAGES, k0 = j * BK;
      const int ps = (j + STAGES - 1) % STAGES;   // v_{j-1}'s stage
      uint8_t kv[BK / 32];
      load_mask<BK>(kv, mrow, k0, Skv, lane);
      // both waits before the products: a wait's spin loop between them
      // would make ptxas serialize them
      sm90::mbar_wait(&full_k[st], (j / STAGES) & 1);
      if constexpr (!kFirst)
        sm90::mbar_wait(&full_v[ps], ((j - 1) / STAGES) & 1);
      sm90::fence_regs<BK / 2>(s);
      if constexpr (!kFirst) {
        sm90::fence_regs<D / 2>(o);
        sm90::fence_regs<BK / 4>(&pa[0][0]);
      }
      sm90::wgmma_fence();
      qk<C>(s, sQ, sK + st * C::KV_BYTES);
      sm90::wgmma_commit();
      if constexpr (!kFirst) {
        pv<C>(o, pa, sV + ps * C::KV_BYTES);
        sm90::wgmma_commit();
      }
      uint32_t vm[BK / 32];
      const bool all_valid = ballot_mask<BK>(vm, kv, tq);
      sm90::wgmma_wait<kFirst ? 0 : 1>();
      sm90::fence_regs<BK / 2>(s);
      if (lane == 0) sm90::mbar_arrive(&empty_k[st]);   // k_j read

      float corr[2], rs[2];
      const int lim = r0 + off - k0;   // row r0 sees columns <= lim
      if (kCausal && k0 + BK - 1 > wq0 + off)   // the tile crosses the band
        softmax_tile<BK, 2>(s, m, corr, rs, vm, lim, tq, sl2);
      else if (!all_valid)
        softmax_tile<BK, 1>(s, m, corr, rs, vm, lim, tq, sl2);
      else
        softmax_tile<BK, 0>(s, m, corr, rs, vm, lim, tq, sl2);
      if constexpr (!kFirst) {
        sm90::wgmma_wait<0>();
        sm90::fence_regs<D / 2>(o);
        if (lane == 0) sm90::mbar_arrive(&empty_v[ps]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
      // p as bf16 A fragments of the k16 slices of the tile's keys
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = sm90::pack_bf16(s[8 * kk + 2 * r],
                                      s[8 * kk + 2 * r + 1]);
    };

    if (n_kv > 0) {
      sm90::mbar_wait(q_bar, 0);
      step(0, std::true_type());
      for (int j = 1; j < n_kv; ++j) step(j, std::false_type());
      // the last tile's p v
      const int ls = (n_kv - 1) % STAGES;
      sm90::mbar_wait(&full_v[ls], ((n_kv - 1) / STAGES) & 1);
      sm90::fence_regs<D / 2>(o);
      sm90::fence_regs<BK / 4>(&pa[0][0]);
      sm90::wgmma_fence();
      pv<C>(o, pa, sV + ls * C::KV_BYTES);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<D / 2>(o);
    }

    // out rows r0 (+8), columns 8j + 2tq (+1); rows past Sq not written
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row >= Sq) continue;
      const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
      bf16* dst = out + ((size_t)bh * Sq + row) * D + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * jj) = sm90::pack_bf16(
            o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
      if (lse != nullptr && tq == 0)
        lse[(size_t)bh * Sq + row] =
            l[i] > 0.0f ? (m[i] + log2f(l[i])) * LN2 : kNegInf;
    }
  }
}

// ------------------------------------------------------------------ host
template <class C, bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* lse, int B, int H, int Sq, int Skv, float scale,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<C, kCausal>;
  // setmaxnreg moves registers between the warpgroups of the CTA's launch
  // allocation: refuse to launch (rather than hang) if it is too small
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs * C::THREADS
      < 128 * (PRODUCER_REGS + C::NWG * C::CONSUMER_REGS))
    return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (sm90::encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  const int BH = B * H;
  if (!sm90::make_map(&tq, q, C::D, Sq, BH, C::BQ)
      || !sm90::make_map(&tk, k, C::D, Skv, BH, C::BK)
      || !sm90::make_map(&tv, v, C::D, Skv, BH, C::BK))
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3(BH, (Sq + C::BQ - 1) / C::BQ), C::THREADS, C::SMEM,
           stream>>>(tq, tk, tv, static_cast<const uint8_t*>(mask),
                     static_cast<bf16*>(out), static_cast<float*>(lse), H,
                     Sq, Skv, scale);
  return (int)cudaGetLastError();
}

using Cfg64 = Cfg<64, 1, 64, 3>;
using Cfg128 = Cfg<128, 2, 128, 1>;

}  // namespace

// q (B, H, Sq, D), k/v (B, H, Skv, D) bf16; mask (B, Skv) uint8 (nonzero =
// valid key); out (B, H, Sq, D) bf16; lse (B, H, Sq) f32 or null; all
// contiguous and 16-byte aligned.  D is 64 or 128.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int groma_flash_fwd(const void* q, const void* k, const void* v,
                               const void* mask, void* out, void* lse, int B,
                               int H, int Sq, int Skv, int D, float scale,
                               int causal, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1) return (int)cudaErrorInvalidValue;
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  auto* run = D == 64 ? (causal ? launch<Cfg64, true> : launch<Cfg64, false>)
                      : (causal ? launch<Cfg128, true>
                                : launch<Cfg128, false>);
  return run(q, k, v, mask, out, lse, B, H, Sq, Skv, scale,
             static_cast<cudaStream_t>(stream));
}
