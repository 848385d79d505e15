// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 statistics.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of tpufw/ops/flash.py
// (launched by `_flash_fwd_impl`): O = softmax(mask(cap(scale*QK^T)))*V by
// online softmax over kv tiles, plus LSE = m + log(l) (l = 0 -> 1).
//
// What bounds it on an H100: the two products are 4*T*S*D FLOPs per head
// (halved by the causal triangle) against (T+2S)*D*2 bytes of input per
// head, so at T = S = 2048 it is bound by tensor-core operations, not
// memory. This first version is simple rather than fast: one block per
// (query tile, head, batch) keeps its Q tile in shared memory and streams
// K/V tiles through it; the products use wmma bf16 fragments with fp32
// accumulation. The causal and window bounds skip kv tiles that are wholly
// masked, as the TPU kernel's loop bounds do. GQA never materializes
// repeated K/V: query head h reads kv head h / (H / KV). The running output
// lives in fp32 shared memory so each kv tile can rescale it by
// exp(m_prev - m_new). wgmma, TMA and warp specialisation are later work.

#include "flash_common.cuh"

namespace tpufw {

constexpr int FWD_SMEM =
    3 * TILE_H_BYTES + TILE_S_BYTES + TILE_P_BYTES + TILE_O_BYTES + 3 * BQ * 4;

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, Masks m) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + 64 * LDH;
  bf16* sV = sK + 64 * LDH;
  float* sS = reinterpret_cast<float*>(sV + 64 * LDH);
  bf16* sP = reinterpret_cast<bf16*>(sS + 64 * LDS);
  float* sO = reinterpret_cast<float*>(sP + 64 * LDP);
  float* sM = sO + 64 * LDO;
  float* sL = sM + BQ;
  float* sAlpha = sL + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * BQ;
  const bf16* qb = q + ((long)b * m.T * H + h) * D;
  const bf16* kb = k + ((long)b * m.S * KV + kvh) * D;
  const bf16* vb = v + ((long)b * m.S * KV + kvh) * D;

  load_tile(sQ, qb, q0, m.T, (long)H * D);
  for (int i = threadIdx.x; i < 64 * LDO; i += NTHREADS) sO[i] = 0.0f;
  if (threadIdx.x < BQ) {
    sM[threadIdx.x] = NEG_INF;
    sL[threadIdx.x] = 0.0f;
  }
  int j0, j_hi;
  kv_range(qt, m, &j0, &j_hi);
  __syncthreads();

  const int r0 = warp * 16;
  for (int j = j0; j < j_hi; ++j) {
    load_tile(sK, kb, j * BKV, m.S, (long)KV * D);
    load_tile(sV, vb, j * BKV, m.S, (long)KV * D);
    __syncthreads();

    warp_abt(sS + r0 * LDS, sQ + r0 * LDH, sK);
    __syncwarp();

    // Online-softmax update of this warp's 16 rows; lane owns 2 columns.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int q_row = q0 + r;
      const int qs = (m.qseg && q_row < m.T) ? m.qseg[(long)b * m.T + q_row] : 0;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        const int kpos = j * BKV + c;
        const float val = capped_logit(sS[r * LDS + c], m);
        const int ks = (m.kseg && kpos < m.S) ? m.kseg[(long)b * m.S + kpos] : 0;
        const bool ok = kpos < m.S && visible(q_row, kpos, qs, ks, m);
        x[e] = ok ? val : NEG_INF;
      }
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x[0], x[1])));
      const float p0 = expf(x[0] - m_new), p1 = expf(x[1] - m_new);
      const float alpha = expf(m_prev - m_new);
      const float psum = warp_sum(p0 + p1);
      sP[r * LDP + lane] = __float2bfloat16(p0);
      sP[r * LDP + lane + 32] = __float2bfloat16(p1);
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + psum;
        sAlpha[r] = alpha;
      }
    }
    __syncwarp();

    // O = O * alpha + P V for this warp's rows.
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = r0 + i / D;
      sO[r * LDO + i % D] *= sAlpha[r];
    }
    __syncwarp();
    FragC acc[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::load_matrix_sync(acc[n], sO + r0 * LDO + n * 16, LDO, wmma::mem_row_major);
    warp_pb(acc, sP + r0 * LDP, sV);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(sO + r0 * LDO + n * 16, acc[n], LDO, wmma::mem_row_major);
    __syncthreads();  // sK/sV are overwritten by the next tile
  }

  // Epilogue: O = acc / l, LSE = m + log(l), with l = 0 -> 1.
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = r0 + i / D, c = i % D;
    const int t = q0 + r;
    if (t < m.T) {
      const float l = sL[r] == 0.0f ? 1.0f : sL[r];
      o[((long)b * m.T + t) * H * D + (long)h * D + c] =
          __float2bfloat16(sO[r * LDO + c] / l);
    }
  }
  if (lane < 16) {
    const int r = r0 + lane, t = q0 + r;
    if (t < m.T) {
      const float l = sL[r] == 0.0f ? 1.0f : sL[r];
      lse[((long)b * H + h) * m.T + t] = sM[r] + logf(l);
    }
  }
}

}  // namespace tpufw

// q [B,T,H,D], k/v [B,S,KV,D] bf16; o [B,T,H,D] bf16; lse [B,H,T] fp32;
// qseg [B,T] / kseg [B,S] int32 or null. Returns cudaGetLastError().
extern "C" int tpufw_flash_fwd(const void* q, const void* k, const void* v,
                               const void* qseg, const void* kseg, void* o,
                               void* lse, int B, int T, int S, int H, int KV,
                               int causal, int offset, int has_window,
                               int window, int has_cap, float cap,
                               void* stream) {
  using namespace tpufw;
  cudaFuncSetAttribute(flash_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  const Masks m = make_masks(T, S, causal, offset, has_window, window, has_cap,
                             cap, qseg, kseg);
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, NTHREADS, FWD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, KV, m);
  return (int)cudaGetLastError();
}
