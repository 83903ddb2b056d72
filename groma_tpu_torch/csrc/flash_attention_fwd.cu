// Flash-attention forward on Hopper (sm_90a): bf16 q/k/v, f32 online
// softmax, bf16 out and (on request) the f32 log-sum-exp of every row.
//
// Replaces two TPU kernels of groma_tpu/ops/flash_attention.py:
//   * `_fwd_wholekv_kernel` (bidirectional, the whole kv range in one VMEM
//     block; DINOv2 at (B, 16, 1025, 64)) -- the `kCausal = false`
//     instantiation;
//   * `_fwd_kernel` over the packed live causal block pairs (LLaMA at
//     (B, 32, 2048, 128)) -- the `kCausal = true` instantiation, which skips
//     the kv tiles above the diagonal as `_causal_pairs` does.
// Semantics of both: a (B, S_kv) key mask is applied to the scores before
// the row max; a row with no valid key gives out 0 and lse -1e30.
//
// What bounds it: tensor-core work, 4 * S_q * S_kv * D flops per head
// (halved by the causal skip), against 2 * (S_q + 2 S_kv) * D bytes.  The
// TPU kept all keys of an encoder row in VMEM to shed its per-grid-step
// overhead; a Hopper block has 227 KB of shared memory and no such
// overhead, so both cases use the same FlashAttention-2 loop instead: one
// block owns 64 query rows (4 warps x 16 rows), holds its q fragments in
// registers for the whole run, and walks the kv range in 64-key tiles
// staged in shared memory (k row-major, v transposed so that both products
// read 32-bit fragments; rows padded by 8 bf16 so the fragment reads of a
// warp hit 32 distinct banks).  Products are mma.sync m16n8k16 bf16 with
// f32 accumulation; the softmax statistics live in registers, reduced over
// the 4 lanes that share a row.  wgmma, TMA and a load pipeline are later
// work.  Plain version and wrapper: groma_tpu_torch/ops/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::kNegInf;

template <int D, bool kCausal>
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                 bf16* __restrict__ out, float* __restrict__ lse, int H,
                 int Sq, int Skv, float scale) {
  constexpr int BQ = 64, BK = 64;
  constexpr int KP = D + 8;    // k row pitch (bf16)
  constexpr int VP = BK + 8;   // transposed-v row pitch (bf16)
  __shared__ __align__(16) bf16 ks[BK * KP];
  __shared__ __align__(16) bf16 vt[D * VP];
  __shared__ uint8_t kv_ok[BK];

  const int nq = (Sq + BQ - 1) / BQ;
  // causal: the longest rows first, so the last wave is short
  const int qt = kCausal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = qt * BQ;
  const int off = Skv - Sq;
  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)bh * Skv * D;
  const bf16* vb = v + (size_t)bh * Skv * D;
  const uint8_t* mb = mask + (size_t)b * Skv;

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  uint32_t qa[D / 16][4];
  flash::load_a_global<D>(qa, qb, row, Sq, tig);

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  int n_kv = (Skv + BK - 1) / BK;
  if (kCausal) {
    const int last = q0 + BQ - 1 + off;   // the tile's last visible key
    n_kv = min(n_kv, last >= 0 ? last / BK + 1 : 0);
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's reads are done
    flash::stage_rows<D, BK, KP>(ks, kb, k0, Skv, tid);
    flash::stage_transposed<D, BK, VP>(vt, vb, k0, Skv, tid);
    if (tid < BK) kv_ok[tid] = (k0 + tid < Skv) && mb[k0 + tid];
    __syncthreads();

    // s = q k^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        uint32_t bf[2];
        flash::load_b(bf, ks, KP, nt * 8 + g, kc * 16 + 2 * tig);
        flash::mma_bf16(s[nt], qa[kc], bf);
      }

    // mask before the row max; invalid scores are exactly kNegInf
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        bool ok = kv_ok[col];
        if (kCausal) ok = ok && (k0 + col <= row[e >> 1] + off);
        const float x = ok ? s[nt][e] * scale : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = flash::quad_max(mx[i]);
      corr[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        const float p = x > 0.5f * kNegInf ? __expf(x - m[e >> 1]) : 0.0f;
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // o += p v, p rounded to bf16 as the TPU kernel does
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pa[4];
      flash::c_to_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t bf[2];
        flash::load_b(bf, vt, VP, dt * 8 + g, j * 16 + 2 * tig);
        flash::mma_bf16(o[dt], pa, bf);
      }
    }
  }

  bf16* ob = out + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = flash::quad_sum(l[i]);
    if (row[i] >= Sq) continue;
    const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(
          ob + (size_t)row[i] * D + dt * 8 + 2 * tig) = val;
    }
    if (lse != nullptr && tig == 0)
      lse[(size_t)bh * Sq + row[i]] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : kNegInf;
  }
}

template <int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* lse, int B, int H, int Sq, int Skv, float scale,
           cudaStream_t stream) {
  const dim3 grid((Sq + 63) / 64, B * H);
  flash_fwd_kernel<D, kCausal><<<grid, 128, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(out), static_cast<float*>(lse), H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return causal ? launch<64, true>(q, k, v, mask, out, lse, B, H, Sq, Skv,
                                     scale, st)
                  : launch<64, false>(q, k, v, mask, out, lse, B, H, Sq, Skv,
                                      scale, st);
  if (D == 128)
    return causal ? launch<128, true>(q, k, v, mask, out, lse, B, H, Sq, Skv,
                                      scale, st)
                  : launch<128, false>(q, k, v, mask, out, lse, B, H, Sq,
                                       Skv, scale, st);
  return (int)cudaErrorInvalidValue;
}
