// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, bf16 in, fp32 accumulation.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` of
// tpufw/ops/flash.py (launched by `_flash_bwd_impl`). Both recompute
// P = exp(cap(scale*qk^T) - lse) from the forward's LSE instead of storing
// it, and dS = P*(dP - delta) with dP = dO*V^T, times 1 - (capped/cap)^2
// under a soft cap. delta = rowsum(dO*O) and the GQA sum of dK/dV are done
// outside, in torch, as the JAX package does.
//
// What bounds them on an H100: dQ does 3 products and dK/dV 4 per (query,
// key) pair against a few bytes per row, so both are bound by tensor-core
// operations. This first version is simple rather than fast: wmma bf16
// fragments with fp32 accumulators, P and dS rounded to bf16 for their
// products as FlashAttention-2 does, scalar fp32 code for the masks.
// - dQ: one block per (query tile, query head, batch); the kv loop runs
//   over the forward's causal/window bounds and dQ stays in registers.
// - dK/dV: one block per (kv tile, QUERY head, batch), looping over query
//   tiles from the causal first to the window's last; dK and dV stay in
//   registers and are stored fp32 per query head, like the TPU kernel, so
//   no two blocks write the same output and no atomics are needed.

#include "flash_common.cuh"

namespace tpufw {

constexpr int DQ_SMEM = 4 * TILE_H_BYTES + 2 * TILE_S_BYTES + TILE_P_BYTES + 2 * BQ * 4;
constexpr int DKV_SMEM =
    4 * TILE_H_BYTES + 2 * TILE_S_BYTES + 2 * TILE_P_BYTES + 2 * BQ * 4;
static_assert(2 * TILE_S_BYTES >= TILE_O_BYTES, "dQ epilogue reuses sS+sdP");

__global__ void __launch_bounds__(NTHREADS)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int H, int KV, Masks m) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + 64 * LDH;
  bf16* sK = sDO + 64 * LDH;
  bf16* sV = sK + 64 * LDH;
  float* sS = reinterpret_cast<float*>(sV + 64 * LDH);
  float* sDP = sS + 64 * LDS;
  bf16* sDS = reinterpret_cast<bf16*>(sDP + 64 * LDS);
  float* sLse = reinterpret_cast<float*>(sDS + 64 * LDP);
  float* sDelta = sLse + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * BQ;
  const long q_off = ((long)b * m.T * H + h) * D;
  const bf16* kb = k + ((long)b * m.S * KV + kvh) * D;
  const bf16* vb = v + ((long)b * m.S * KV + kvh) * D;

  load_tile(sQ, q + q_off, q0, m.T, (long)H * D);
  load_tile(sDO, dout + q_off, q0, m.T, (long)H * D);
  if (threadIdx.x < BQ) {
    const int t = q0 + threadIdx.x;
    const long idx = ((long)b * H + h) * m.T + t;
    sLse[threadIdx.x] = t < m.T ? lse[idx] : 0.0f;
    sDelta[threadIdx.x] = t < m.T ? delta[idx] : 0.0f;
  }
  int j0, j_hi;
  kv_range(qt, m, &j0, &j_hi);
  __syncthreads();

  const int r0 = warp * 16;
  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);

  for (int j = j0; j < j_hi; ++j) {
    load_tile(sK, kb, j * BKV, m.S, (long)KV * D);
    load_tile(sV, vb, j * BKV, m.S, (long)KV * D);
    __syncthreads();

    warp_abt(sS + r0 * LDS, sQ + r0 * LDH, sK);    // q k^T
    warp_abt(sDP + r0 * LDS, sDO + r0 * LDH, sV);  // dO v^T
    __syncwarp();

    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int q_row = q0 + r;
      const int qs = (m.qseg && q_row < m.T) ? m.qseg[(long)b * m.T + q_row] : 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        const int kpos = j * BKV + c;
        const float capped = capped_logit(sS[r * LDS + c], m);
        const int ks = (m.kseg && kpos < m.S) ? m.kseg[(long)b * m.S + kpos] : 0;
        const bool ok = kpos < m.S && visible(q_row, kpos, qs, ks, m);
        const float p = ok ? expf(capped - sLse[r]) : 0.0f;
        float ds = p * (sDP[r * LDS + c] - sDelta[r]);
        if (m.has_cap) {
          const float tc = capped / m.cap;
          ds *= 1.0f - tc * tc;
        }
        sDS[r * LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    warp_pb(acc, sDS + r0 * LDP, sK);  // dQ += dS k
    __syncthreads();
  }

  // Epilogue through shared memory (sS/sdP are free): dQ * scale -> bf16.
  float* sOut = sS;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(sOut + r0 * LDO + n * 16, acc[n], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = r0 + i / D, c = i % D;
    const int t = q0 + r;
    if (t < m.T)
      dq[q_off + (long)t * H * D + c] = __float2bfloat16(sOut[r * LDO + c] * m.scale);
  }
}

__global__ void __launch_bounds__(NTHREADS)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
                 Masks m) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + 64 * LDH;
  bf16* sQ = sV + 64 * LDH;
  bf16* sDO = sQ + 64 * LDH;
  float* sSt = reinterpret_cast<float*>(sDO + 64 * LDH);  // [kv][q]
  float* sDPt = sSt + 64 * LDS;
  bf16* sPt = reinterpret_cast<bf16*>(sDPt + 64 * LDS);
  bf16* sDSt = sPt + 64 * LDP;
  float* sLse = reinterpret_cast<float*>(sDSt + 64 * LDP);
  float* sDelta = sLse + BQ;

  const int jt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = jt * BKV;
  const long q_off = ((long)b * m.T * H + h) * D;

  load_tile(sK, k + ((long)b * m.S * KV + kvh) * D, k0, m.S, (long)KV * D);
  load_tile(sV, v + ((long)b * m.S * KV + kvh) * D, k0, m.S, (long)KV * D);

  // Query tiles that can see this kv tile (tpufw/ops/flash.py:300-313).
  const int n_q = (m.T + BQ - 1) / BQ;
  int i0 = 0, i_hi = n_q;
  if (m.causal) i0 = max((k0 - m.offset) / BQ, 0);
  if (m.has_window) {
    const int last_q = k0 + BKV - 1 + m.window - 1 - m.offset;
    i_hi = max(min(last_q / BQ + 1, n_q), i0);
  }

  const int c0 = warp * 16;  // this warp's 16 kv rows
  const int kpos_base = k0 + c0;
  FragC acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(acc_dk[n], 0.0f);
    wmma::fill_fragment(acc_dv[n], 0.0f);
  }

  for (int it = i0; it < i_hi; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // previous tile's sQ/sDO/sLse readers are done
    load_tile(sQ, q + q_off, q0, m.T, (long)H * D);
    load_tile(sDO, dout + q_off, q0, m.T, (long)H * D);
    if (threadIdx.x < BQ) {
      const int t = q0 + threadIdx.x;
      const long idx = ((long)b * H + h) * m.T + t;
      sLse[threadIdx.x] = t < m.T ? lse[idx] : 0.0f;
      sDelta[threadIdx.x] = t < m.T ? delta[idx] : 0.0f;
    }
    __syncthreads();

    warp_abt(sSt + c0 * LDS, sK + c0 * LDH, sQ);    // k q^T
    warp_abt(sDPt + c0 * LDS, sV + c0 * LDH, sDO);  // v dO^T
    __syncwarp();

    for (int cc = 0; cc < 16; ++cc) {
      const int c = c0 + cc;
      const int kpos = kpos_base + cc;
      const int ks = (m.kseg && kpos < m.S) ? m.kseg[(long)b * m.S + kpos] : 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = lane + 32 * e;
        const int q_row = q0 + qc;
        const float capped = capped_logit(sSt[c * LDS + qc], m);
        bool ok = q_row < m.T;
        if (ok) {
          const int qs = m.qseg ? m.qseg[(long)b * m.T + q_row] : 0;
          ok = visible(q_row, kpos, qs, ks, m);
        }
        const float p = ok ? expf(capped - sLse[qc]) : 0.0f;
        float ds = p * (sDPt[c * LDS + qc] - sDelta[qc]);
        if (m.has_cap) {
          const float tc = capped / m.cap;
          ds *= 1.0f - tc * tc;
        }
        sPt[c * LDP + qc] = __float2bfloat16(p);
        sDSt[c * LDP + qc] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    warp_pb(acc_dv, sPt + c0 * LDP, sDO);  // dV += P^T dO
    warp_pb(acc_dk, sDSt + c0 * LDP, sQ);  // dK += dS^T q
  }

  // dK, dV are [B, H, S_pad, D] fp32 (S_pad a multiple of 64): whole tiles
  // go straight from the fragments to device memory.
  const long out_off = (((long)b * H + h) * (long)gridDim.x * BKV + kpos_base) * D;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int e = 0; e < acc_dk[n].num_elements; ++e) acc_dk[n].x[e] *= m.scale;
    wmma::store_matrix_sync(dk + out_off + n * 16, acc_dk[n], D, wmma::mem_row_major);
    wmma::store_matrix_sync(dv + out_off + n * 16, acc_dv[n], D, wmma::mem_row_major);
  }
}

}  // namespace tpufw

// Shared argument order: q [B,T,H,D], k/v [B,S,KV,D], dO [B,T,H,D] bf16;
// lse, delta [B,H,T] fp32; qseg [B,T] / kseg [B,S] int32 or null.

// dq [B,T,H,D] bf16. Returns cudaGetLastError().
extern "C" int tpufw_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* qseg,
                              const void* kseg, void* dq, int B, int T, int S,
                              int H, int KV, int causal, int offset,
                              int has_window, int window, int has_cap,
                              float cap, void* stream) {
  using namespace tpufw;
  cudaFuncSetAttribute(flash_dq_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  const Masks m = make_masks(T, S, causal, offset, has_window, window, has_cap,
                             cap, qseg, kseg);
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_dq_kernel<<<grid, NTHREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, KV, m);
  return (int)cudaGetLastError();
}

// dk, dv [B,H,S_pad,D] fp32 per QUERY head, S_pad = S rounded up to 64.
extern "C" int tpufw_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* qseg,
                               const void* kseg, void* dk, void* dv, int B,
                               int T, int S, int H, int KV, int causal,
                               int offset, int has_window, int window,
                               int has_cap, float cap, void* stream) {
  using namespace tpufw;
  cudaFuncSetAttribute(flash_dkv_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  const Masks m = make_masks(T, S, causal, offset, has_window, window, has_cap,
                             cap, qseg, kseg);
  dim3 grid((S + BKV - 1) / BKV, H, B);
  flash_dkv_kernel<<<grid, NTHREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, KV, m);
  return (int)cudaGetLastError();
}
