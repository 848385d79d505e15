// Flash-attention dQ for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `_dq_kernel` of tpufw/ops/flash.py
// (launched by `_flash_bwd_impl`). It recomputes P = exp(cap(scale*qk^T) -
// lse) from the forward's LSE instead of storing it, forms dS = P*(dP -
// delta) with dP = dO*V^T, times 1 - (capped/cap)^2 under a soft cap, and
// accumulates dQ = scale * sum_j dS_j K_j over the forward's kv tiles.
// delta = rowsum(dO*O) is computed outside, in torch, as the JAX package
// does. The dK/dV kernel is in flash_dkv.cu.
//
// What bounds it on an H100: three products per (query, key) pair against
// a few bytes per row, so tensor-core operations. The design is the
// forward's (flash_fwd.cu):
// - one block per (128-row query tile, head, batch), heaviest causal tiles
//   launched first; 384 threads: warpgroups 0 and 1 each own 64 query rows,
//   one warp of warpgroup 2 is the producer, and setmaxnreg moves the
//   producer's registers to the consumers;
// - TMA copies Q and dO once and streams 128-key K and V tiles through a
//   2-stage ring of full/empty mbarriers; the producer's lanes stage each
//   tile's key segment ids. Rows past T or S read as zeros within their own
//   batch: the TPU kernel's padding;
// - S = Q K^T and dP = dO V^T run on wgmma (m64n128k16, K-major operands,
//   fp32 accumulators in registers) as one batch; P and dS are formed in
//   place on the accumulator layout, with each row's LSE and delta held in
//   registers for the whole loop and the mask only on tiles that some pair
//   fails; dS goes as bf16 register A operands into dQ += dS K, with K read
//   MN-major as the forward reads V. dQ stays in registers;
// - dQ leaves through shared memory (the dead Q rows) by TMA store.
// Loop bounds: the forward's kv_tiles (flash_common.cuh), in C's truncating
// division as jax.lax.div. GQA never materializes repeated K/V: query head
// h reads kv head h/(H/KV).
//
// Head dim 256 (flash_dq_d256.cu, Gemma-2): Q and dO alone take 128 KB, so
// the kv tiles are 64 keys and the ring has one stage (Q, dO, K and V fill
// 192 KB of the 227 KB a block may have): the next tile's copy waits for
// this tile's math. S and dP are m64n64 over 16 k-steps, dQ two m64n128
// accumulators (128 fp32 registers a thread).
//
// Head dim 192 (flash_dq_d192.cu, DeepSeek's MLA): Q and dO take 96 KB, so
// 64-key tiles fit a two-stage ring (2 x 48 KB: 192 KB in all); the ring
// depth is derived from those bytes. S and dP are m64n64 over 12 k-steps,
// dQ one m64n192 accumulator (96 fp32 registers a thread).
//
// Tile builds, as the forward's (flash_fwd.cu): TPUFW_BQ (128 or 64 query
// rows a block, one consumer warpgroup per 64) and TPUFW_BKV (128 or 64
// keys a tile), defaulting to the tiles above; flash_dq_k64.cu is 128 x 64
// at D = 128, flash_dq_d192_q64.cu and flash_dq_d256_q64.cu 64 x 64. At
// D = 256 the 64-row block halves Q and dO (64 KB), so its ring has two
// stages again (192 KB). No 32-key build (the dK/dV kernel has none to
// pair with, flash_dkv.cu) and no 128-key one at D = 192 or 256: S, dP
// and dQ take 64 + 64 + 128 fp32 registers a thread at 256 (and 224 at
// 192, with K, V and dS still to come), past the 240 a consumer has.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace tpufw {
namespace grad_q {

using namespace hopper;

#ifdef TPUFW_BQ
constexpr int BQ = TPUFW_BQ;              // query rows per block
#else
constexpr int BQ = 128;
#endif
#ifdef TPUFW_BKV
constexpr int BKV = TPUFW_BKV;            // keys per kv tile
#else
constexpr int BKV = D == 128 ? 128 : 64;
#endif
static_assert(BQ == 64 || BQ == 128, "a consumer warpgroup owns 64 query rows");
static_assert(BKV == 64 || BKV == 128, "S and dP are m64n64 or m64n128 products");
constexpr int CONSUMERS = BQ / 64;        // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer's warpgroup
// Register bound of every build: the 384-thread one's (flash_fwd.cu).
constexpr int BOUND_THREADS = 384;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int NS = BKV / 2;   // S and dP accumulator floats a thread

constexpr int Q_ATOM = BQ * 128;    // 64 columns of the Q or dO tile
constexpr int KV_ATOM = BKV * 128;  // 64 columns of a K or V tile
constexpr int Q_BYTES = ATOMS * Q_ATOM;
constexpr int KV_BYTES = ATOMS * KV_ATOM;
// K/V ring depth: two stages where Q, dO and two stages of K and V fit a
// block's 227 KB with 4 KB to spare for the segment ids and barriers (D =
// 128: 192 KB; 192: 192 KB), else one (256: 256 KB would not fit).
constexpr int STAGES = 2 * Q_BYTES + 4 * KV_BYTES + 4096 <= 232448 ? 2 : 1;
constexpr int Q_OFF = 0;
constexpr int DO_OFF = Q_OFF + Q_BYTES;
constexpr int K_OFF = DO_OFF + Q_BYTES;
constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
constexpr int KSEG_OFF = V_OFF + STAGES * KV_BYTES;  // int [STAGES][BKV]
constexpr int BAR_OFF = KSEG_OFF + STAGES * BKV * 4;
constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;  // + alignment
static_assert(SMEM <= 232448, "more shared memory than an H100 block may have");

constexpr float LOG2E = 1.4426950408889634f;

// S and dP of one kv tile -> dS, in place in dp on the accumulator layout.
// lse2 and dlt are this thread's rows' LSE * log2(e) and delta. P =
// exp(capped - lse) (0 where MASKED and a pair fails a mask), dS = P (dP -
// delta) times 1 - (capped/cap)^2 under a soft cap. Templated so that
// neither the soft cap nor the mask costs a branch per element.
template <bool CAP, bool MASKED, int N>
__device__ __forceinline__ void tile_grads(float (&s)[N], float (&dp)[N], const Masks& m,
                                           int k0, const int (&q_row)[2], const int (&qs)[2],
                                           const float (&lse2)[2], const float (&dlt)[2],
                                           const int* kseg_tile, int t4) {
  const float inv_cap = CAP ? 1.0f / m.cap : 0.0f;
  if (CAP) {
    // The capped logits first, in a pass of their own, as in flash_dkv.cu:
    // tanhf needs many registers.
    const float scale_cap = m.scale * inv_cap;
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = m.cap * tanhf(s[i] * scale_cap);
  }
  const float to_log2 = CAP ? LOG2E : m.scale * LOG2E;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int rh = (i >> 1) & 1;
    float p = fast_exp2(s[i] * to_log2 - lse2[rh]);
    if (MASKED) {
      const int col = (i / 4) * 8 + 2 * t4 + (i & 1);
      const int kpos = k0 + col;
      const int ks = m.kseg ? kseg_tile[col] : 0;
      p = kpos < m.S && visible(q_row[rh], kpos, qs[rh], ks, m) ? p : 0.0f;
    }
    float ds = p * (dp[i] - dlt[rh]);
    if (CAP) {
      const float tc = s[i] * inv_cap;  // capped / cap
      ds *= 1.0f - tc * tc;
    }
    dp[i] = ds;
  }
}

__global__ void __launch_bounds__(BOUND_THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap domap,
                const __grid_constant__ CUtensorMap dqmap,
                const float* __restrict__ lse, const float* __restrict__ delta, int H,
                int KV, Masks m) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;
  int* skseg = reinterpret_cast<int*>(smem + KSEG_OFF);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int wg = threadIdx.x / 128;
  int j0, j_hi;
  kv_tiles<BQ, BKV>(qt, m, &j0, &j_hi);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // every producer lane arrives
      mbar_init(&empty[s], 4 * CONSUMERS);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer: one warp issues the copies; lanes stage key segment ids.
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x / 32 != 4 * CONSUMERS) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * Q_BYTES);
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(smem + Q_OFF + a * Q_ATOM, &qmap, bar_q, a * HALF_COLS, h, q0, b);
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(smem + DO_OFF + a * Q_ATOM, &domap, bar_q, a * HALF_COLS, h, q0, b);
    }
    for (int j = j0; j < j_hi; ++j) {
      const int n = j - j0, s = n % STAGES;
      const int k0 = j * BKV;
      mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
      if (m.kseg) {
        for (int i = lane; i < BKV; i += 32)
          skseg[s * BKV + i] = k0 + i < m.S ? m.kseg[(long)b * m.S + k0 + i] : -1;
      }
      if (lane == 0) {
        unsigned char* kd = smem + K_OFF + s * KV_BYTES;
        unsigned char* vd = smem + V_OFF + s * KV_BYTES;
        mbar_arrive_expect_tx(&full[s], 2 * KV_BYTES);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_4d(kd + a * KV_ATOM, &kmap, &full[s], a * HALF_COLS, kvh, k0, b);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_4d(vd + a * KV_ATOM, &vmap, &full[s], a * HALF_COLS, kvh, k0, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [qw0, qw0 + 64). A row's LSE,
  // delta and segment id are read once: a dQ block's rows never change.
  regs_alloc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, t4 = lane % 4;
  const int row = (tid / 32) * 16 + lane / 4;  // this thread's rows: row, row + 8
  const int qw0 = q0 + wg * 64;
  int q_row[2], qs[2] = {0, 0};
  float lse2[2], dlt[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    q_row[rh] = qw0 + row + 8 * rh;
    const bool ok = q_row[rh] < m.T;
    const long idx = ((long)b * H + h) * m.T + q_row[rh];
    lse2[rh] = ok ? lse[idx] * LOG2E : 0.0f;
    dlt[rh] = ok ? delta[idx] : 0.0f;
    if (m.qseg && ok) qs[rh] = m.qseg[(long)b * m.T + q_row[rh]];
  }
  float dq[NO][OC / 2], s[NS], dp[NS];  // NO accumulators of OC columns
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int i = 0; i < OC / 2; ++i) dq[c][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.0f;

  const uint32_t q_base = smem_u32(smem + Q_OFF) + wg * 64 * 128;
  const uint32_t do_base = smem_u32(smem + DO_OFF) + wg * 64 * 128;
  mbar_wait(bar_q, 0);
  for (int j = j0; j < j_hi; ++j) {
    const int n = j - j0, st = n % STAGES;
    const int k0 = j * BKV;
    const uint32_t k_base = smem_u32(smem + K_OFF + st * KV_BYTES);
    const uint32_t v_base = smem_u32(smem + V_OFF + st * KV_BYTES);
    mbar_wait(&full[st], (n / STAGES) & 1);

    // S = Q K^T and dP = dO V^T: D/16 k-steps of 16 over D each, K-major
    // operands, one batch. The register fences keep every write of an
    // accumulator out of the batch (ptxas would serialize it).
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * Q_ATOM + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * KV_ATOM + (kk % 4) * 32;
      wgmma_ss_acc(s, make_desc(q_base + a_off, 16, 1024),
                   make_desc(k_base + b_off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * Q_ATOM + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * KV_ATOM + (kk % 4) * 32;
      wgmma_ss_acc(dp, make_desc(do_base + a_off, 16, 1024),
                   make_desc(v_base + b_off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS in place; the mask only where some pair of the tile fails it.
    bool interior = m.qseg == nullptr && k0 + BKV <= m.S;
    if (m.causal) interior = interior && qw0 + m.offset >= k0 + BKV - 1;
    if (m.has_window) interior = interior && qw0 + 63 + m.offset - k0 < m.window;
    const int* kseg_tile = skseg + st * BKV;
    if (interior) {
      if (m.has_cap) tile_grads<true, false>(s, dp, m, k0, q_row, qs, lse2, dlt, kseg_tile, t4);
      else tile_grads<false, false>(s, dp, m, k0, q_row, qs, lse2, dlt, kseg_tile, t4);
    } else {
      if (m.has_cap) tile_grads<true, true>(s, dp, m, k0, q_row, qs, lse2, dlt, kseg_tile, t4);
      else tile_grads<false, true>(s, dp, m, k0, q_row, qs, lse2, dlt, kseg_tile, t4);
    }
    // dS in bf16: the accumulator layout is the A-fragment layout.
    uint32_t ds[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) ds[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);

    // dQ += dS K: BKV/16 k-steps of 16 keys, K MN-major (atoms KV_ATOM
    // apart), one m64nOC product per OC columns of dQ.
#pragma unroll
    for (int c = 0; c < NO; ++c) fence_regs(dq[c]);
    fence_regs(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < NO; ++c)
        wgmma_rs_tb(dq[c], a,
                    make_desc(k_base + c * OC_ATOMS * KV_ATOM + kk * 16 * 128, KV_ATOM, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NO; ++c) fence_regs(dq[c]);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // Epilogue: dQ * scale in bf16 into this warpgroup's dead Q rows,
  // swizzled as the dQ map reads them, then one TMA store per atom; rows
  // past T are dropped.
  unsigned char* ob = smem + Q_OFF + wg * 64 * 128;
#pragma unroll
  for (int c = 0; c < NO; ++c) {
#pragma unroll
    for (int n8 = 0; n8 < OC / 8; ++n8) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int r = row + 8 * rh, col = (n8 % 8) * 8 + 2 * t4;
        const int atom = c * OC_ATOMS + n8 / 8;
        *reinterpret_cast<uint32_t*>(ob + atom * Q_ATOM + swizzle_offset(r, col)) =
            pack_bf16(dq[c][4 * n8 + 2 * rh] * m.scale, dq[c][4 * n8 + 2 * rh + 1] * m.scale);
      }
    }
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);
  if (tid == 0) {
    for (int a = 0; a < ATOMS; ++a)
      tma_store_4d(&dqmap, ob + a * Q_ATOM, a * HALF_COLS, h, qw0, b);
    tma_store_commit_and_wait();
  }
}

}  // namespace grad_q
}  // namespace tpufw

// q [B,T,H,D], k/v [B,S,KV,D], dO [B,T,H,D] bf16; lse, delta [B,H,T] fp32;
// qseg [B,T] / kseg [B,S] int32 or null; dq [B,T,H,D] bf16. Returns
// cudaGetLastError(), or cudaErrorInvalidValue when a tensor map cannot be
// encoded.
extern "C" int tpufw_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* qseg,
                              const void* kseg, void* dq, int B, int T, int S,
                              int H, int KV, int causal, int offset,
                              int has_window, int window, int has_cap,
                              float cap, void* stream) {
  using namespace tpufw::grad_q;
  CUtensorMap qmap, kmap, vmap, domap, dqmap;
  using tpufw::D;
  if (!tpufw::hopper::encode_rows_map(&qmap, q, B, T, H, BQ, D) ||
      !tpufw::hopper::encode_rows_map(&domap, dout, B, T, H, BQ, D) ||
      !tpufw::hopper::encode_rows_map(&kmap, k, B, S, KV, BKV, D) ||
      !tpufw::hopper::encode_rows_map(&vmap, v, B, S, KV, BKV, D) ||
      !tpufw::hopper::encode_rows_map(&dqmap, dq, B, T, H, 64, D))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM);
  const tpufw::Masks m = tpufw::make_masks(T, S, causal, offset, has_window, window,
                                           has_cap, cap, qseg, kseg);
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_dq_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, domap, dqmap, static_cast<const float*>(lse),
      static_cast<const float*>(delta), H, KV, m);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of this build's block in bytes (ptxas reports only
// static shared memory; chip_smoke.py prints this beside its report).
extern "C" int tpufw_flash_dq_smem() { return tpufw::grad_q::SMEM; }
