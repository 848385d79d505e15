// Flash-attention dK/dV for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `_dkv_kernel` of tpufw/ops/flash.py
// (launched by `_flash_bwd_impl`). Per (kv tile, QUERY head, batch) it
// loops over the query tiles that can see the kv tile, recomputes
// P^T = exp(cap(scale*k q^T) - lse) from the forward's LSE, and forms
// dS^T = P^T*(dP^T - delta) with dP^T = v dO^T, times 1 - (capped/cap)^2
// under a soft cap; dV += P^T dO and dK += dS^T q. delta = rowsum(dO*O)
// and the GQA sum over a kv head's query heads stay in torch, as in the
// JAX package, so no two blocks write the same output and no atomics are
// needed. The output is fp32 [B, H, S_pad, D] per query head, scaled by
// `scale`, with S_pad a multiple of the key tile (BKV).
//
// What bounds it on an H100: four products per (query, key) pair against
// a few bytes per row, so tensor-core operations. The design:
// - 384 threads: warpgroups 0 and 1 each own 64 of the block's 128 keys,
//   one warp of warpgroup 2 is the producer; setmaxnreg hands the
//   producer's registers to the consumers, which keep dK and dV (64 fp32
//   each) in registers for the whole loop;
// - TMA loads K and V once and streams 64-row Q and dO tiles through a
//   2-stage ring of full/empty mbarriers; the producer's lanes stage each
//   tile's LSE (pre-scaled by log2(e)), delta and query segment ids;
// - S^T = K Q^T and dP^T = V dO^T run on wgmma (m64n64k16) from
//   128B-swizzled shared memory; P^T and dS^T are formed in registers on
//   the accumulator layout, with the mask only on tiles that some pair
//   fails, and go as bf16 register A operands into dV += P^T dO and
//   dK += dS^T Q (m64n128k16, dO and Q read MN-major).
// Loop bounds: from the causal first query tile to the window's last, in
// C's truncating division as jax.lax.div.
//
// Head dim 256 (flash_dkv_d256.cu, Gemma-2): dK and dV of 64 keys x 256
// would take 256 fp32 registers a thread, more than a warpgroup has. So a
// block owns 64 keys, and its two consumer warpgroups split the outputs:
// warpgroup 0 forms S^T and P^T and keeps dV, warpgroup 1 forms S^T, dP^T
// and dS^T and keeps dK (128 registers of accumulator each). S^T is thus
// computed twice, and warpgroup 1 runs three products to warpgroup 0's two:
// a simple split, not a balanced one. K, V and two stages of Q and dO
// (64-row tiles) fill 192 KB of shared memory.
//
// Head dim 192 (flash_dkv_d192.cu, DeepSeek's MLA) keeps the split: dK and
// dV of 64 keys x 192 together with S^T and dP^T would pass the 240
// registers a consumer thread has, while one m64n192 accumulator each (96
// fp32 registers) leaves room. K and V (48 KB) and two stages of Q and dO
// (2 x 48 KB) take 144 KB. With V zero-padded by the model, a third of dV's
// columns are zero and are computed all the same.
//
// Tile builds. TPUFW_BKV (keys a block, 128 or 64) chooses the key tile;
// 64 keys take the split layout above at every head dim, so
// flash_dkv_k64.cu is the D = 128 kernel at 64 keys, each warpgroup keeping
// one of dK and dV (64 fp32 registers). The streamed query tile (BQ, 64
// rows) is this kernel's own constant: the tile override's query axis is
// the forward's and dQ's. At D = 192 and 256 there is no other key tile:
// the keys are the wgmma M axis, 64 rows a warpgroup, so a 32-key block
// would leave half of every product empty, and a 128-key block would keep
// dV (or dK) of 128 keys x D in one warpgroup's registers (256 fp32 a
// thread at D = 256, 192 at 192 beside S^T and dP^T), past the 240 a
// consumer thread has.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace tpufw {
namespace dkv {

using namespace hopper;

#ifdef TPUFW_BKV
constexpr int BKV = TPUFW_BKV;         // keys per block
#else
constexpr int BKV = D == 128 ? 128 : 64;
#endif
static_assert(BKV == 128 ? D == 128 : BKV == 64,
              "128 keys a block at D = 128, else 64 (see the notes above)");
// 64 keys a block (D = 192 and 256, or the 64-key build at 128): each
// warpgroup keeps one of dK and dV for all the block's keys.
constexpr bool SPLIT = BKV == 64;
constexpr int BQ = 64;        // query rows per streamed tile
constexpr int STAGES = 2;     // Q/dO ring depth
constexpr int THREADS = 384;  // two consumer warpgroups + the producer's
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

constexpr int KV_ATOM = BKV * 128;  // 64 columns of the K or V tile
constexpr int Q_ATOM = BQ * 128;    // 64 columns of a Q or dO tile
constexpr int K_OFF = 0;
constexpr int V_OFF = K_OFF + ATOMS * KV_ATOM;
constexpr int STAGE_OFF = V_OFF + ATOMS * KV_ATOM;  // [STAGES] x (Q, dO)
constexpr int STAGE_BYTES = 2 * ATOMS * Q_ATOM;
constexpr int ROWS_OFF = STAGE_OFF + STAGES * STAGE_BYTES;  // lse2, delta, qseg
constexpr int BAR_OFF = ROWS_OFF + 3 * STAGES * BQ * 4;
constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;  // + alignment
static_assert(SMEM <= 232448, "more shared memory than an H100 block may have");

constexpr float LOG2E = 1.4426950408889634f;

// Query tiles [i0, i_hi) that can see kv tile jt. Mirrors
// flash.py:dkv_q_tiles, which tests/test_torch_flash_tiles.py checks on the
// CPU: an edit here must be made there too.
__device__ __forceinline__ void q_tiles(int jt, const Masks& m, int* i0, int* i_hi) {
  const int n_q = (m.T + BQ - 1) / BQ;
  const int k0 = jt * BKV;
  *i0 = m.causal ? max((k0 - m.offset) / BQ, 0) : 0;
  *i_hi = n_q;
  if (m.has_window) {
    const int last_q = k0 + BKV - 1 + m.window - 1 - m.offset;
    *i_hi = max(min(last_q / BQ + 1, n_q), *i0);
  }
}

// S^T and dP^T of one query tile -> P^T and dS^T, in place on the
// accumulator layout. Column c is query row q0 + c; tl, td and tq are the
// tile's LSE * log2(e), delta and query segment ids. P^T = exp(capped -
// lse) (0 where MASKED and a pair fails a mask), dS^T = P^T (dP^T - delta)
// times 1 - (capped/cap)^2 under a soft cap; without DS only P^T (dpt is
// then not read). Templated so that neither the soft cap nor the mask
// costs a branch per element.
template <bool CAP, bool MASKED, bool DS>
__device__ __forceinline__ void tile_grads(float (&st)[32], float (&dpt)[32],
                                           const Masks& m, int q0,
                                           const int (&kpos)[2], const int (&ks)[2],
                                           const float* tl, const float* td,
                                           const int* tq, int t4) {
  const float inv_cap = CAP ? 1.0f / m.cap : 0.0f;
  if (CAP) {
    // The capped logits first, in a pass of their own: tanhf needs many
    // registers, and next to the rest of the pass it made ptxas spill.
    const float scale_cap = m.scale * inv_cap;
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = m.cap * tanhf(st[i] * scale_cap);
  }
  const float to_log2 = CAP ? LOG2E : m.scale * LOG2E;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = (i / 4) * 8 + 2 * t4 + (i & 1), rh = (i >> 1) & 1;
    float p = fast_exp2(st[i] * to_log2 - tl[col]);
    if (MASKED) {
      const int t = q0 + col;
      const bool ok = t < m.T && visible(t, kpos[rh], m.qseg ? tq[col] : 0, ks[rh], m);
      p = ok ? p : 0.0f;
    }
    if (DS) {
      float ds = p * (dpt[i] - td[col]);
      if (CAP) {
        const float tc = st[i] * inv_cap;  // capped / cap
        ds *= 1.0f - tc * tc;
      }
      dpt[i] = ds;
    }
    st[i] = p;
  }
}

// One consumer warpgroup over the query tiles [i0, i_hi): it owns keys
// [kw0, kw0 + 64) and keeps dV (DV) and/or dK (DK) in registers for the
// whole loop, then writes them to [B, H, S_pad, D].
template <bool DV, bool DK>
__device__ __forceinline__ void consume(unsigned char* smem, const Masks& m, int kw0,
                                        int i0, int i_hi, uint64_t* full, uint64_t* empty,
                                        const float* slse, const float* sdelta,
                                        const int* sqseg, float* __restrict__ dk,
                                        float* __restrict__ dv, int b, int h, int H) {
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, t4 = lane % 4;
  const int row = (tid / 32) * 16 + lane / 4;  // this thread's keys: row, row + 8
  int kpos[2], ks[2] = {0, 0};
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    kpos[rh] = kw0 + row + 8 * rh;
    if (m.kseg && kpos[rh] < m.S) ks[rh] = m.kseg[(long)b * m.S + kpos[rh]];
  }
  // NO accumulators of OC columns each for dK and dV (m64 x OC).
  float dk_acc[NO][OC / 2], dv_acc[NO][OC / 2], st_acc[32], dpt_acc[32];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int i = 0; i < OC / 2; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.0f;

  const uint32_t kv_row = (kw0 % BKV) * 128;  // this warpgroup's first key row
  const uint32_t k_base = smem_u32(smem + K_OFF) + kv_row;
  const uint32_t v_base = smem_u32(smem + V_OFF) + kv_row;
  for (int it = i0; it < i_hi; ++it) {
    const int n = it - i0, st = n % STAGES;
    const int q0 = it * BQ;
    const uint32_t q_base = smem_u32(smem + STAGE_OFF + st * STAGE_BYTES);
    const uint32_t do_base = q_base + ATOMS * Q_ATOM;
    mbar_wait(&full[st], (n / STAGES) & 1);

    // S^T = K Q^T and (DK) dP^T = V dO^T: D/16 k-steps of 16 over D,
    // K-major.
    fence_regs(st_acc);
    if constexpr (DK) fence_regs(dpt_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * KV_ATOM + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * Q_ATOM + (kk % 4) * 32;
      wgmma_ss_m64n64(st_acc, make_desc(k_base + a_off, 16, 1024),
                      make_desc(q_base + b_off, 16, 1024), kk > 0);
    }
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * KV_ATOM + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * Q_ATOM + (kk % 4) * 32;
        wgmma_ss_m64n64(dpt_acc, make_desc(v_base + a_off, 16, 1024),
                        make_desc(do_base + b_off, 16, 1024), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st_acc);
    if constexpr (DK) fence_regs(dpt_acc);

    // P^T and dS^T in place; the mask only where some pair of the tile
    // fails it.
    bool interior = m.qseg == nullptr && q0 + BQ <= m.T;
    if (m.causal) interior = interior && q0 + m.offset >= kw0 + 63;
    if (m.has_window) interior = interior && q0 + BQ - 1 + m.offset - kw0 < m.window;
    const float* tl = slse + st * BQ;
    const float* td = sdelta + st * BQ;
    const int* tq = sqseg + st * BQ;
    if (interior) {
      if (m.has_cap) tile_grads<true, false, DK>(st_acc, dpt_acc, m, q0, kpos, ks, tl, td, tq, t4);
      else tile_grads<false, false, DK>(st_acc, dpt_acc, m, q0, kpos, ks, tl, td, tq, t4);
    } else {
      if (m.has_cap) tile_grads<true, true, DK>(st_acc, dpt_acc, m, q0, kpos, ks, tl, td, tq, t4);
      else tile_grads<false, true, DK>(st_acc, dpt_acc, m, q0, kpos, ks, tl, td, tq, t4);
    }
    uint32_t pb[16], dsb[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if constexpr (DV) pb[i] = pack_bf16(st_acc[2 * i], st_acc[2 * i + 1]);
      if constexpr (DK) dsb[i] = pack_bf16(dpt_acc[2 * i], dpt_acc[2 * i + 1]);
    }

    // dV += P^T dO and dK += dS^T Q: 4 k-steps of 16 query rows, B MN-major
    // (atoms 8 KB apart), one m64nOC product per OC columns.
    if constexpr (DV) {
      fence_regs(pb);
#pragma unroll
      for (int c = 0; c < NO; ++c) fence_regs(dv_acc[c]);
    }
    if constexpr (DK) {
      fence_regs(dsb);
#pragma unroll
      for (int c = 0; c < NO; ++c) fence_regs(dk_acc[c]);
    }
    wgmma_fence();
    if constexpr (DV) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {pb[4 * kk], pb[4 * kk + 1], pb[4 * kk + 2], pb[4 * kk + 3]};
#pragma unroll
        for (int c = 0; c < NO; ++c)
          wgmma_rs_tb(dv_acc[c], a,
                      make_desc(do_base + c * OC_ATOMS * Q_ATOM + kk * 16 * 128, Q_ATOM, 1024));
      }
    }
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {dsb[4 * kk], dsb[4 * kk + 1], dsb[4 * kk + 2],
                               dsb[4 * kk + 3]};
#pragma unroll
        for (int c = 0; c < NO; ++c)
          wgmma_rs_tb(dk_acc[c], a,
                      make_desc(q_base + c * OC_ATOMS * Q_ATOM + kk * 16 * 128, Q_ATOM, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    if constexpr (DV) {
#pragma unroll
      for (int c = 0; c < NO; ++c) fence_regs(dv_acc[c]);
    }
    if constexpr (DK) {
#pragma unroll
      for (int c = 0; c < NO; ++c) fence_regs(dk_acc[c]);
    }
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // Whole key tiles go straight from the accumulators to [B,H,S_pad,D].
  const long s_pad = (long)gridDim.x * BKV;
#pragma unroll
  for (int c = 0; c < NO; ++c) {
#pragma unroll
    for (int n8 = 0; n8 < OC / 8; ++n8) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const long off =
            (((long)b * H + h) * s_pad + kpos[rh]) * D + c * OC + n8 * 8 + 2 * t4;
        const int i = 4 * n8 + 2 * rh;
        if constexpr (DK)
          *reinterpret_cast<float2*>(dk + off) =
              make_float2(dk_acc[c][i] * m.scale, dk_acc[c][i + 1] * m.scale);
        if constexpr (DV)
          *reinterpret_cast<float2*>(dv + off) = make_float2(dv_acc[c][i], dv_acc[c][i + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
                 Masks m) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;
  float* slse = reinterpret_cast<float*>(smem + ROWS_OFF);  // lse * log2(e)
  float* sdelta = slse + STAGES * BQ;
  int* sqseg = reinterpret_cast<int*>(sdelta + STAGES * BQ);

  const int jt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int k0 = jt * BKV;
  const int wg = threadIdx.x / 128;
  int i0, i_hi;
  q_tiles(jt, m, &i0, &i_hi);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // every producer lane arrives
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: one warp issues the copies; lanes stage the per-row inputs.
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x / 32 != 8) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * ATOMS * KV_ATOM);
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(smem + K_OFF + a * KV_ATOM, &kmap, bar_kv, a * HALF_COLS, kvh, k0, b);
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(smem + V_OFF + a * KV_ATOM, &vmap, bar_kv, a * HALF_COLS, kvh, k0, b);
    }
    for (int it = i0; it < i_hi; ++it) {
      const int n = it - i0, s = n % STAGES;
      const int q0 = it * BQ;
      mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
      for (int i = lane; i < BQ; i += 32) {
        const int t = q0 + i;
        const bool ok = t < m.T;
        const long idx = ((long)b * H + h) * m.T + t;
        slse[s * BQ + i] = ok ? lse[idx] * LOG2E : 0.0f;
        sdelta[s * BQ + i] = ok ? delta[idx] : 0.0f;
        if (m.qseg) sqseg[s * BQ + i] = ok ? m.qseg[(long)b * m.T + t] : -1;
      }
      if (lane == 0) {
        unsigned char* qd = smem + STAGE_OFF + s * STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_4d(qd + a * Q_ATOM, &qmap, &full[s], a * HALF_COLS, h, q0, b);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_4d(qd + (ATOMS + a) * Q_ATOM, &domap, &full[s], a * HALF_COLS, h, q0,
                      b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumers.
  regs_alloc<CONSUMER_REGS>();
  mbar_wait(bar_kv, 0);
  if constexpr (SPLIT) {
    if (wg == 0)
      consume<true, false>(smem, m, k0, i0, i_hi, full, empty, slse, sdelta, sqseg,
                           dk, dv, b, h, H);
    else
      consume<false, true>(smem, m, k0, i0, i_hi, full, empty, slse, sdelta, sqseg,
                           dk, dv, b, h, H);
  } else {
    consume<true, true>(smem, m, k0 + wg * 64, i0, i_hi, full, empty, slse, sdelta,
                        sqseg, dk, dv, b, h, H);
  }
}

}  // namespace dkv
}  // namespace tpufw

// q [B,T,H,D], k/v [B,S,KV,D], dO [B,T,H,D] bf16; lse, delta [B,H,T] fp32;
// qseg [B,T] / kseg [B,S] int32 or null; dk, dv [B,H,S_pad,D] fp32 per
// QUERY head, S_pad = S rounded up to BKV (128, or 64 at D = 192 and 256
// and in the 64-key build).
// Returns cudaGetLastError(), or
// cudaErrorInvalidValue when a tensor map cannot be encoded.
extern "C" int tpufw_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* qseg,
                               const void* kseg, void* dk, void* dv, int B,
                               int T, int S, int H, int KV, int causal,
                               int offset, int has_window, int window,
                               int has_cap, float cap, void* stream) {
  using namespace tpufw::dkv;
  CUtensorMap qmap, kmap, vmap, domap;
  using tpufw::D;
  if (!tpufw::hopper::encode_rows_map(&qmap, q, B, T, H, BQ, D) ||
      !tpufw::hopper::encode_rows_map(&domap, dout, B, T, H, BQ, D) ||
      !tpufw::hopper::encode_rows_map(&kmap, k, B, S, KV, BKV, D) ||
      !tpufw::hopper::encode_rows_map(&vmap, v, B, S, KV, BKV, D))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(flash_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM);
  const tpufw::Masks m = tpufw::make_masks(T, S, causal, offset, has_window, window, has_cap,
                             cap, qseg, kseg);
  dim3 grid((S + BKV - 1) / BKV, H, B);
  flash_dkv_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, domap, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), H, KV, m);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of this build's block in bytes (ptxas reports only
// static shared memory; chip_smoke.py prints this beside its report).
extern "C" int tpufw_flash_dkv_smem() { return tpufw::dkv::SMEM; }
