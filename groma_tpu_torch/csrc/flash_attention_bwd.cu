// Causal flash-attention backward on Hopper (sm_90a): dq, dk, dv in bf16
// from bf16 q/k/v/do, the forward's f32 lse and delta = rowsum(do * out),
// with f32 accumulation.
//
// Replaces the TPU kernel `_bwd_fused_kernel` of
// groma_tpu/ops/flash_attention.py (LLaMA at (B, 32, 2048, 128)), with its
// numerics: p = exp(scale * q.k - lse) under the key mask and the causal
// mask, dv += p^T do with p rounded to bf16, dp = do v^T,
// ds = p (dp - delta) scale rounded to bf16, dk += ds^T q, dq += ds k.
// The TPU kernel walks kv-major live block pairs in one pass and carries dq
// for the whole sequence in a VMEM scratch from one grid step to the next.
// Hopper blocks run in no order, so nothing can carry over between them;
// this port splits the work into two kernels with no atomics instead:
//   * `dkdv`: one block per 64-key tile (4 warps x 16 keys) walks the query
//     tiles from the diagonal down, recomputing p and dp^T in registers;
//   * `dq`: one block per 64-query tile (4 warps x 16 rows) walks the key
//     tiles up to the diagonal, as the forward does.
// The price is one more q.k and do.v^T product per live tile pair (7
// products instead of 5); the gain is a deterministic dq.  What bounds it:
// tensor-core work, as in the forward.  Each product operand is staged in
// shared memory in the orientation its fragment needs (row-major and
// transposed copies, rows padded by 8 bf16).  Plain version and wrapper:
// groma_tpu_torch/ops/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::kNegInf;

// ---------------------------------------------------------------- dk, dv
template <int D>
struct DkdvSmem {
  static constexpr int BK = 64, BQ = 32, KP = D + 8, TP = BQ + 8;
  static constexpr size_t bytes =
      (size_t)(2 * BK * KP + 2 * BQ * KP + 2 * D * TP) * sizeof(bf16)
      + 2 * BQ * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const uint8_t* __restrict__ mask,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int Sq, int Skv,
                      float scale) {
  using L = DkdvSmem<D>;
  constexpr int BK = L::BK, BQ = L::BQ, KP = L::KP, TP = L::TP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // BK x KP  k
  bf16* vs = ks + BK * KP;                        // BK x KP  v
  bf16* qs = vs + BK * KP;                        // BQ x KP  q
  bf16* dos = qs + BQ * KP;                       // BQ x KP  do
  bf16* qt = dos + BQ * KP;                       // D x TP   q^T
  bf16* dot = qt + D * TP;                        // D x TP   do^T
  float* lse_s = reinterpret_cast<float*>(dot + D * TP);
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.y, b = bh / H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int off = Skv - Sq;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Skv * D;

  flash::stage_rows<D, BK, KP>(ks, k + kbase, k0, Skv, tid);
  flash::stage_rows<D, BK, KP>(vs, v + kbase, k0, Skv, tid);
  const int kr[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  bool kv_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kv_ok[i] = kr[i] < Skv && mask[(size_t)b * Skv + kr[i]];

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.0f;

  // the first query that sees key k0 is k0 - off
  const int nq = (Sq + BQ - 1) / BQ;
  const int qt_first = max(0, k0 - off) / BQ;
  const int wr = warp * 16;   // this warp's rows in ks / vs

  for (int qtile = qt_first; qtile < nq; ++qtile) {
    const int q0 = qtile * BQ;
    __syncthreads();
    flash::stage_rows<D, BQ, KP>(qs, q + qbase, q0, Sq, tid);
    flash::stage_rows<D, BQ, KP>(dos, dout + qbase, q0, Sq, tid);
    flash::stage_transposed<D, BQ, TP>(qt, q + qbase, q0, Sq, tid);
    flash::stage_transposed<D, BQ, TP>(dot, dout + qbase, q0, Sq, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < Sq;
      lse_s[tid] = in ? lse[(size_t)bh * Sq + q0 + tid] : 0.0f;
      delta_s[tid] = in ? delta[(size_t)bh * Sq + q0 + tid] : 0.0f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T for this warp's 16 keys x BQ queries
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ka[4], va[4];
      flash::load_a(ka, ks, KP, wr + g, kc * 16 + 2 * tig);
      flash::load_a(va, vs, KP, wr + g, kc * 16 + 2 * tig);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        uint32_t bq[2], bd[2];
        flash::load_b(bq, qs, KP, nt * 8 + g, kc * 16 + 2 * tig);
        flash::load_b(bd, dos, KP, nt * 8 + g, kc * 16 + 2 * tig);
        flash::mma_bf16(st[nt], ka, bq);
        flash::mma_bf16(dpt[nt], va, bd);
      }
    }
    // p^T and ds^T in place
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * tig + (e & 1);
        const bool ok = kv_ok[e >> 1] && q0 + qc < Sq
                        && kr[e >> 1] <= q0 + qc + off;
        const float p = ok ? __expf(st[nt][e] * scale - lse_s[qc]) : 0.0f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - delta_s[qc]) * scale;
      }
    // dv += p^T do, dk += ds^T q
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      uint32_t pa[4], da[4];
      flash::c_to_a(pa, st[2 * j], st[2 * j + 1]);
      flash::c_to_a(da, dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t bo[2], bq[2];
        flash::load_b(bo, dot, TP, dt * 8 + g, j * 16 + 2 * tig);
        flash::load_b(bq, qt, TP, dt * 8 + g, j * 16 + 2 * tig);
        flash::mma_bf16(dv_acc[dt], pa, bo);
        flash::mma_bf16(dk_acc[dt], da, bq);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kr[i] >= Skv) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const size_t at = kbase + (size_t)kr[i] * D + dt * 8 + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          dk_acc[dt][2 * i], dk_acc[dt][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(
          dv_acc[dt][2 * i], dv_acc[dt][2 * i + 1]);
    }
  }
}

// -------------------------------------------------------------------- dq
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const uint8_t* __restrict__ mask,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int Sq, int Skv, float scale) {
  constexpr int BQ = 64, BK = 32, KP = D + 8, TP = BK + 8;
  __shared__ __align__(16) bf16 ks[BK * KP];   // k   (B of s = q k^T)
  __shared__ __align__(16) bf16 vs[BK * KP];   // v   (B of dp = do v^T)
  __shared__ __align__(16) bf16 kt[D * TP];    // k^T (B of dq += ds k)
  __shared__ uint8_t kv_ok[BK];

  const int nq = (Sq + BQ - 1) / BQ;
  const int qtile = nq - 1 - (int)blockIdx.x;   // longest rows first
  const int bh = blockIdx.y, b = bh / H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = qtile * BQ;
  const int off = Skv - Sq;
  const size_t qbase = (size_t)bh * Sq * D, kbase = (size_t)bh * Skv * D;
  const uint8_t* mb = mask + (size_t)b * Skv;

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  uint32_t qa[D / 16][4], da[D / 16][4];
  flash::load_a_global<D>(qa, q + qbase, row, Sq, tig);
  flash::load_a_global<D>(da, dout + qbase, row, Sq, tig);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < Sq;
    lse_r[i] = in ? lse[(size_t)bh * Sq + row[i]] : 0.0f;
    delta_r[i] = in ? delta[(size_t)bh * Sq + row[i]] : 0.0f;
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[i][e] = 0.0f;

  const int last = q0 + BQ - 1 + off;
  const int n_kv = min((Skv + BK - 1) / BK, last >= 0 ? last / BK + 1 : 0);
  for (int ktile = 0; ktile < n_kv; ++ktile) {
    const int k0 = ktile * BK;
    __syncthreads();
    flash::stage_rows<D, BK, KP>(ks, k + kbase, k0, Skv, tid);
    flash::stage_rows<D, BK, KP>(vs, v + kbase, k0, Skv, tid);
    flash::stage_transposed<D, BK, TP>(kt, k + kbase, k0, Skv, tid);
    if (tid < BK) kv_ok[tid] = (k0 + tid < Skv) && mb[k0 + tid];
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        uint32_t bk[2], bv[2];
        flash::load_b(bk, ks, KP, nt * 8 + g, kc * 16 + 2 * tig);
        flash::load_b(bv, vs, KP, nt * 8 + g, kc * 16 + 2 * tig);
        flash::mma_bf16(s[nt], qa[kc], bk);
        flash::mma_bf16(dp[nt], da[kc], bv);
      }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        const bool ok = kv_ok[col] && k0 + col <= row[e >> 1] + off;
        const float p =
            ok ? __expf(s[nt][e] * scale - lse_r[e >> 1]) : 0.0f;
        dp[nt][e] = p * (dp[nt][e] - delta_r[e >> 1]) * scale;
      }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t dsa[4];
      flash::c_to_a(dsa, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t bk[2];
        flash::load_b(bk, kt, TP, dt * 8 + g, j * 16 + 2 * tig);
        flash::mma_bf16(dq_acc[dt], dsa, bk);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + qbase + (size_t)row[i] * D + dt * 8 + 2 * tig) =
          __floats2bfloat162_rn(dq_acc[dt][2 * i], dq_acc[dt][2 * i + 1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* dout, const void* lse, const void* delta, void* dq,
           void* dk, void* dv, int B, int H, int Sq, int Skv, float scale,
           cudaStream_t stream) {
  const size_t smem = DkdvSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* mp = static_cast<const uint8_t*>(mask);
  const auto* dop = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);
  flash_bwd_dkdv_kernel<D><<<dim3((Skv + 63) / 64, B * H), 128, smem,
                             stream>>>(qp, kp, vp, mp, dop, lp, dlp,
                                       static_cast<bf16*>(dk),
                                       static_cast<bf16*>(dv), H, Sq, Skv,
                                       scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D><<<dim3((Sq + 63) / 64, B * H), 128, 0, stream>>>(
      qp, kp, vp, mp, dop, lp, dlp, static_cast<bf16*>(dq), H, Sq, Skv,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Causal only.  q/do (B, H, Sq, D), k/v (B, H, Skv, D) bf16; mask (B, Skv)
// uint8; lse/delta (B, H, Sq) f32; dq (B, H, Sq, D), dk/dv (B, H, Skv, D)
// bf16; all contiguous and 16-byte aligned; D is 64 or 128.  Launches the
// dk/dv kernel, then the dq kernel, on `stream`.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int groma_flash_bwd(const void* q, const void* k, const void* v,
                               const void* mask, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               void* dk, void* dv, int B, int H, int Sq,
                               int Skv, int D, float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, mask, dout, lse, delta, dq, dk, dv, B, H, Sq,
                      Skv, scale, st);
  if (D == 128)
    return launch<128>(q, k, v, mask, dout, lse, delta, dq, dk, dv, B, H, Sq,
                       Skv, scale, st);
  return (int)cudaErrorInvalidValue;
}
