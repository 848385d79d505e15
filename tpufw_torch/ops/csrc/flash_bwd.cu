// Flash-attention dQ for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `_dq_kernel` of tpufw/ops/flash.py
// (launched by `_flash_bwd_impl`). It recomputes P = exp(cap(scale*qk^T) -
// lse) from the forward's LSE instead of storing it, and dS = P*(dP -
// delta) with dP = dO*V^T, times 1 - (capped/cap)^2 under a soft cap.
// delta = rowsum(dO*O) is computed outside, in torch, as the JAX package
// does. The dK/dV kernel is in flash_dkv.cu.
//
// What bounds it on an H100: three products per (query, key) pair against
// a few bytes per row, so tensor-core operations. This first version is
// simple rather than fast: wmma bf16 fragments with fp32 accumulators, P
// and dS rounded to bf16 for their products as FlashAttention-2 does,
// scalar fp32 code for the masks. One block per (query tile, query head,
// batch); the kv loop runs over the forward's causal/window bounds at
// 64-key tiles and dQ stays in registers. Its Hopper redesign (wgmma, TMA)
// is later work, as the forward and dK/dV have had theirs.

#include "flash_common.cuh"

namespace tpufw {

constexpr int DQ_SMEM = 4 * TILE_H_BYTES + 2 * TILE_S_BYTES + TILE_P_BYTES + 2 * BQ * 4;
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
