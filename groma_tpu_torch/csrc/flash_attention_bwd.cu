// Flash-attention backward on Hopper (sm_90a), causal and bidirectional:
// dq, dk, dv in bf16 from bf16 q/k/v/do, the forward's f32 lse and
// delta = rowsum(do * out), with f32 accumulation.
//
// Replaces two TPU kernels of groma_tpu/ops/flash_attention.py, one
// template instantiation each:
//   * CAUSAL = true: `_bwd_fused_kernel` (LLaMA at (B, 32, 2048, 128));
//   * CAUSAL = false: `_bwd_dkv_kernel` + `_bwd_dq_kernel`, the backward of
//     every bidirectional call (DINOv2-L at (B, 16, 1025, 64)), Sq != Skv
//     allowed.
// Their numerics: p = exp(scale * q.k - lse) under the key mask (and the
// causal band, offset Skv - Sq), dv += p^T do with p rounded to bf16,
// dp = do v^T, ds = p (dp - delta) scale rounded to bf16, dk += ds^T q,
// dq += ds k.  A query row past Sq (the tail tile of S = 1025 holds one
// real row) gets p = 0 from an explicit row test, never from its lse: the
// lse of a row with no valid key is -1e30 and exp(s + 1e30) is inf.  A
// batch row whose keys are all masked gets p = 0 everywhere, so its
// gradients are exactly 0.
//
// What bounds it: tensor-core work, 5 products of 2 S_q S_kv D flops per
// (b, h) (2.5x the forward); on the card the dq adds weigh more than the
// products (PERF.md).  The design, one pass like the TPU's causal kernel
// (which carries dq for the whole sequence in a VMEM scratch):
//   * one CTA per 128 keys of one (b, h), warp-specialised: one producer
//     warp keeps TMA loads of the q and do tiles (BQ = 64 rows, 128-byte
//     swizzled, zero-filled past Sq) and of the lse / delta rows in flight
//     through a 2-stage mbarrier ring; k and v are loaded once.  One CTA
//     per SM (setmaxnreg: 24 registers for the producer warpgroup, 240 for
//     the two consumer warpgroups).  D = 64 keeps the same CTA: a 64-key
//     CTA at two per SM was tried and was no faster;
//   * each consumer warpgroup owns 64 keys, the M dimension of every
//     product: s^T = k q^T and dp^T = v do^T come out of wgmma in registers
//     in the layout that wgmma takes as its A operand, so p^T and ds^T feed
//     dv += p^T do and dk += ds^T q straight from registers, with do and q
//     read MN-major (the transpose bit) from the tiles TMA wrote: every tile
//     is staged once, with no transposed copy;
//   * ds^T goes to shared memory once; the consumer warpgroups split dq's
//     columns, dq_part = ds k over all the CTA's keys, and add the part into
//     an f32 workspace (B, H, Sq, D) that the wrapper zeroes, with
//     `red.global.add.v2.f32`; a small kernel then rounds it to bf16 dq.
//     5 products per tile pair, not the 7 of a two-kernel design that
//     recomputes s and dp for dq.  The price: dq's f32 sums are taken in an
//     order that varies from run to run, while dk and dv (one CTA each, the
//     query tiles in a fixed order) stay bitwise deterministic.  A fully
//     masked row adds exact zeros to a zeroed workspace, so it stays 0.
//   * a step commits its products in five groups (s, dp, dv, dq, dk), so
//     that p is computed while dp's product runs, ds while dv's does, and
//     dq's adds are issued while dk's does;
//   * causal: a key tile walks the query tiles from its diagonal down; only
//     the tiles that cross the diagonal test the band; the key tiles with
//     the most query tiles are launched first.
// Plain version and wrapper: groma_tpu_torch/ops/flash_attention.py.

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;              // query rows per step
constexpr int NWG = 2;              // consumer warpgroups, 64 keys each
constexpr int STAGES = 2;           // depth of the q / do ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PRODUCER_REGS = 24;

template <int D>
struct Cfg {
  static constexpr int BK = 64 * NWG;            // keys per CTA
  static constexpr int THREADS = 128 * (NWG + 1);
  // one CTA per SM: the registers a thread gets at launch, and a
  // consumer's after the producer warpgroup gives up all but
  // PRODUCER_REGS of its own (240 of 168 at 384 threads)
  static constexpr int LAUNCH_REGS = (65536 / THREADS) & ~7;
  static constexpr int CONSUMER_REGS =
      ((LAUNCH_REGS * THREADS - 128 * PRODUCER_REGS) / (128 * NWG)) & ~7;
  static constexpr int NDQ = D / NWG;            // dq columns per warpgroup
  static constexpr int K_BYTES = BK * D * 2;     // k or v
  static constexpr int Q_BYTES = BQ * D * 2;     // q or do, one stage
  static constexpr int DS_BYTES = BK * BQ * 2;   // ds^T, one stage
  // byte offsets from a 1024-aligned base (every tile 1024-aligned)
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + K_BYTES;
  static constexpr int OFF_Q = OFF_V + K_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * Q_BYTES;
  static constexpr int OFF_DS = OFF_DO + STAGES * Q_BYTES;
  static constexpr int OFF_LSE = OFF_DS + STAGES * DS_BYTES;
  static constexpr int OFF_DELTA = OFF_LSE + STAGES * BQ * 4;
  static constexpr int OFF_BAR = OFF_DELTA + STAGES * BQ * 4;
  static constexpr size_t SMEM = OFF_BAR + (2 * STAGES + 1) * 8 + 1024;
  static_assert(D % 64 == 0 && NDQ % 32 == 0, "tile shapes");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x N) += a (64 x 16, registers) . b (16 x N, shared, MN-major)
template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t db) {
  if constexpr (N == 64) sm90::wgmma_rs_n64<1>(d, a, db, 1);
  else sm90::wgmma_rs_n128<1>(d, a, db, 1);
}

// d (64 x N) = [d +] a . b, both MN-major in shared memory
template <int N>
__device__ __forceinline__ void mma_ss_t(float* d, uint64_t da, uint64_t db,
                                         int acc) {
  if constexpr (N == 32) sm90::wgmma_ss_n32<1, 1>(d, da, db, acc);
  else sm90::wgmma_ss_n64<1, 1>(d, da, db, acc);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const uint8_t* __restrict__ mask,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 float* __restrict__ dq_ws, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int H, int Sq, int Skv,
                 float scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::OFF_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_bar = empty + STAGES;
  float* lse_s = reinterpret_cast<float*>(base + C::OFF_LSE);
  float* delta_s = reinterpret_cast<float*>(base + C::OFF_DELTA);

  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * BK;    // y = 0 first: the most query tiles
  const int off = Skv - Sq;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qt_first = CAUSAL ? max(0, k0 - off) / BQ : 0;
  const int n_steps = nq - qt_first;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 32);          // the producer warp's lanes
      sm90::mbar_init(&empty[s], 4 * NWG);    // one lane per consumer warp
    }
    sm90::mbar_init(kv_bar, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {
    // ------------------------------------------------------- producer
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid % 128 < 32) {
      const int lane = tid & 31;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(kv_bar, 2 * C::K_BYTES);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          sm90::tma_load_3d(base + C::OFF_K + cb * BK * 128, &tm_k, kv_bar,
                            cb * 64, k0, bh);
          sm90::tma_load_3d(base + C::OFF_V + cb * BK * 128, &tm_v, kv_bar,
                            cb * 64, k0, bh);
        }
      }
      const float* lse_bh = lse + (size_t)bh * Sq;
      const float* delta_bh = delta + (size_t)bh * Sq;
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % STAGES, q0 = (qt_first + it) * BQ;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
#pragma unroll
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < Sq;
          lse_s[s * BQ + r] = in ? lse_bh[q0 + r] * LOG2E : 0.0f;
          delta_s[s * BQ + r] = in ? delta_bh[q0 + r] : 0.0f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[s], 2 * C::Q_BYTES);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb) {
            sm90::tma_load_3d(base + C::OFF_Q + s * C::Q_BYTES
                                  + cb * BQ * 128,
                              &tm_q, &full[s], cb * 64, q0, bh);
            sm90::tma_load_3d(base + C::OFF_DO + s * C::Q_BYTES
                                  + cb * BQ * 128,
                              &tm_do, &full[s], cb * 64, q0, bh);
          }
        } else {
          sm90::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    sm90::setmaxnreg_inc<C::CONSUMER_REGS>();
    const int t = tid % 128, warp = t / 32, lane = t & 31;
    const int g = lane >> 2, tq = lane & 3;
    const uint32_t sK = sm90::smem_u32(base + C::OFF_K);
    const uint32_t sV = sm90::smem_u32(base + C::OFF_V);
    const uint32_t sQ = sm90::smem_u32(base + C::OFF_Q);
    const uint32_t sDO = sm90::smem_u32(base + C::OFF_DO);
    const uint32_t sDS = sm90::smem_u32(base + C::OFF_DS);
    const int kw = k0 + wg * 64;                // this warpgroup's keys
    const int kr0 = kw + warp * 16 + g;         // this thread's: kr0, +8
    bool kv_ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = kr0 + 8 * i;
      kv_ok[i] = kr < Skv && mask[(size_t)b * Skv + kr];
    }
    const float sl2 = scale * LOG2E;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

    sm90::mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % STAGES, q0 = (qt_first + it) * BQ;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t sq = sQ + s * C::Q_BYTES, sdo = sDO + s * C::Q_BYTES;

      // s^T = k q^T, then dp^T = v do^T: 64 keys x 64 queries, K-major
      // operands, one group each, so p is computed while dp^T runs
      float st[BQ / 2], dpt[BQ / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t ka = (kc / 4) * BK * 128 + wg * 64 * 128
                            + (kc % 4) * 32;
        const uint32_t qa = (kc / 4) * BQ * 128 + (kc % 4) * 32;
        sm90::wgmma_ss_n64<0, 0>(st, sm90::desc(sK + ka, 16, 1024),
                                 sm90::desc(sq + qa, 16, 1024), kc > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t ka = (kc / 4) * BK * 128 + wg * 64 * 128
                            + (kc % 4) * 32;
        const uint32_t qa = (kc / 4) * BQ * 128 + (kc % 4) * 32;
        sm90::wgmma_ss_n64<0, 0>(dpt, sm90::desc(sV + ka, 16, 1024),
                                 sm90::desc(sdo + qa, 16, 1024), kc > 0);
      }
      sm90::wgmma_commit();

      // p^T in place; accumulator element 4j + e sits at key row
      // kr0 + 8 (e >> 1), query column 8j + 2 tq + (e & 1)
      const float* ls = lse_s + s * BQ;
      const float* dl = delta_s + s * BQ;
      const bool band = CAUSAL && kw + 63 > q0 + off;
      const bool tail = q0 + BQ > Sq;
      sm90::wgmma_wait<1>();
      sm90::fence_regs<BQ / 2>(st);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + c + (e & 1), kr = kr0 + 8 * (e >> 1);
          bool ok = kv_ok[e >> 1];
          if (tail) ok = ok && q < Sq;
          if (band) ok = ok && kr <= q + off;
          const float lv = (e & 1) ? l2.y : l2.x;
          st[4 * j + e] =
              ok ? ex2(fmaf(st[4 * j + e], sl2, -lv)) : 0.0f;
        }
      }
      // dv += p^T do (p^T as bf16 A fragments of the k16 slices over the
      // 64 queries; do MN-major, k16 = 16 query rows), while ds^T is made
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = sm90::pack_bf16(st[8 * kk + 2 * r],
                                      st[8 * kk + 2 * r + 1]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<D>(dv_acc, pa[kk], sm90::desc(sdo + kk * 2048, BQ * 128,
                                             1024));
      sm90::wgmma_commit();

      // ds^T = p^T (dp^T - delta) scale; masked entries have p = 0
      sm90::wgmma_wait<1>();
      sm90::fence_regs<BQ / 2>(dpt);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j
                                                           + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] = st[4 * j + e]
                           * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x))
                           * scale;
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = sm90::pack_bf16(dpt[8 * kk + 2 * r],
                                      dpt[8 * kk + 2 * r + 1]);
      // ds^T -> shared (keys x 64 queries, 128-byte swizzled lines)
      {
        uint8_t* dsb = base + C::OFF_DS + s * C::DS_BYTES;
        const int row = wg * 64 + warp * 16 + g;
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int rr = row + 8 * (r & 1), chunk = 2 * kk + (r >> 1);
            *reinterpret_cast<uint32_t*>(dsb + rr * 128
                                         + ((chunk ^ g) << 4) + tq * 4) =
                da[kk][r];
          }
      }

      // dq_part = ds k over all BK keys, this warpgroup's NDQ columns
      // (ds^T and k both MN-major, k16 = 16 key rows), then dk += ds^T q
      // (q MN-major); dq is added in while dk runs
      sm90::fence_proxy_async();
      sm90::named_sync(1, NWG * 128);
      float dq[C::NDQ / 2];
      const uint32_t sds = sDS + s * C::DS_BYTES;
      const uint32_t kcol = ((wg * C::NDQ) / 64) * BK * 128
                            + ((wg * C::NDQ) % 64) * 2;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_ss_t<C::NDQ>(dq, sm90::desc(sds + kk * 2048, C::DS_BYTES, 1024),
                         sm90::desc(sK + kcol + kk * 2048, BK * 128, 1024),
                         kk > 0);
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<D>(dk_acc, da[kk], sm90::desc(sq + kk * 2048, BQ * 128,
                                             1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs<C::NDQ / 2>(dq);

      // dq rows q0 + 16 warp + g (+8), columns wg NDQ + 8j + 2tq (+1)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qr = q0 + warp * 16 + g + 8 * i;
        if (qr >= Sq) continue;
        float* dst = dq_ws + ((size_t)bh * Sq + qr) * D + wg * C::NDQ
                     + 2 * tq;
#pragma unroll
        for (int j = 0; j < C::NDQ / 8; ++j)
          sm90::red_add_f32x2(dst + 8 * j, dq[4 * j + 2 * i],
                              dq[4 * j + 2 * i + 1]);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs<D / 2>(dv_acc);
      sm90::fence_regs<D / 2>(dk_acc);
      if (lane == 0) sm90::mbar_arrive(&empty[s]);   // q, do, lse free
    }

    // dk, dv: key rows kr0 (+8), columns 8j + 2tq (+1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = kr0 + 8 * i;
      if (kr >= Skv) continue;
      const size_t row = ((size_t)bh * Skv + kr) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + row + 8 * j) = sm90::pack_bf16(
            dk_acc[4 * j + 2 * i], dk_acc[4 * j + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + row + 8 * j) = sm90::pack_bf16(
            dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// The f32 dq workspace -> bf16 dq, 4 values a thread per step.
__global__ void dq_to_bf16(const float4* __restrict__ src,
                           uint2* __restrict__ dst, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 f = src[i];
    dst[i] = make_uint2(sm90::pack_bf16(f.x, f.y), sm90::pack_bf16(f.z, f.w));
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (BH, S, D) bf16 as a 3-d map, boxes of 64 columns x `rows` rows of one
// (b, h), 128-byte swizzled; rows past S read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int BH,
              int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* dout, const void* lse, const void* delta,
           void* dq_ws, void* dk, void* dv, int B, int H, int Sq, int Skv,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = flash_bwd_kernel<D, CAUSAL>;
  // setmaxnreg moves registers between the warpgroups of the CTA's launch
  // allocation: refuse to launch (rather than hang) if it is too small
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs * C::THREADS
      < 128 * (PRODUCER_REGS + NWG * C::CONSUMER_REGS))
    return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv, tdo;
  const int BH = B * H;
  if (!make_map(&tq, q, D, Sq, BH, BQ)
      || !make_map(&tdo, dout, D, Sq, BH, BQ)
      || !make_map(&tk, k, D, Skv, BH, C::BK)
      || !make_map(&tv, v, D, Skv, BH, C::BK))
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3(BH, (Skv + C::BK - 1) / C::BK), C::THREADS, C::SMEM,
           stream>>>(tq, tk, tv, tdo, static_cast<const uint8_t*>(mask),
                     static_cast<const float*>(lse),
                     static_cast<const float*>(delta),
                     static_cast<float*>(dq_ws), static_cast<bf16*>(dk),
                     static_cast<bf16*>(dv), H, Sq, Skv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/do (B, H, Sq, D), k/v (B, H, Skv, D) bf16; mask (B, Skv) uint8;
// lse/delta (B, H, Sq) f32; dq_ws (B, H, Sq, D) f32, zeroed by the caller;
// dq (B, H, Sq, D), dk/dv (B, H, Skv, D) bf16; all contiguous and 16-byte
// aligned; D is 64 or 128; causal 0 or 1.  Launches the backward, then
// the dq rounding, on `stream`.  Returns the first CUDA error at launch
// (0 = launched).
extern "C" int groma_flash_bwd(const void* q, const void* k, const void* v,
                               const void* mask, const void* dout,
                               const void* lse, const void* delta,
                               void* dq_ws, void* dq, void* dk, void* dv,
                               int B, int H, int Sq, int Skv, int D,
                               float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  auto* run = D == 64 ? (causal ? launch<64, true> : launch<64, false>)
                      : (causal ? launch<128, true> : launch<128, false>);
  const int err = run(q, k, v, mask, dout, lse, delta, dq_ws, dk, dv, B, H,
                      Sq, Skv, scale, st);
  if (err != 0) return err;
  const size_t n4 = (size_t)B * H * Sq * D / 4;
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256
                                                    : 4096);
  dq_to_bf16<<<blocks, 256, 0, st>>>(static_cast<const float4*>(dq_ws),
                                     static_cast<uint2*>(dq), n4);
  return (int)cudaGetLastError();
}
