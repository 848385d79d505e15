// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 statistics.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of tpufw/ops/flash.py
// (launched by `_flash_fwd_impl`): O = softmax(mask(cap(scale*QK^T)))*V by
// online softmax over kv tiles, plus LSE = m + log(l) (l = 0 -> 1).
//
// What bounds it on an H100: the two products are 4*T*S*D FLOPs per head
// (halved by the causal triangle) against (T+2S)*D*2 bytes of input per
// head, so at T = S = 2048 it is bound by tensor-core operations, not
// memory. The design follows from that:
// - one block per (128-row query tile, head, batch), heaviest causal tiles
//   launched first; 384 threads: warpgroups 0 and 1 each own 64 query rows,
//   one warp of warpgroup 2 is the producer, and setmaxnreg moves the
//   producer's registers to the consumers;
// - TMA copies Q once and streams 128-key K and V tiles through a 2-stage
//   ring of full/empty mbarriers, so the next tile's copy overlaps this
//   tile's math. The maps are 4-D over the real [B, N, heads, D] layouts,
//   so rows past T or S read as zeros within their own batch: that zero
//   fill is the key padding of the TPU kernel;
// - S = Q K^T and O += P V run on wgmma (m64n128k16, fp32 accumulators in
//   registers); K and V are read from 128B-swizzled shared memory, V with
//   the transpose flag, and P goes from the S accumulator to the A
//   registers of the P V product without touching shared memory;
// - the online softmax runs in registers on the accumulator layout (a row
//   lives in one quad), in base 2 with exp2; the running output is rescaled
//   in registers. Tiles that every mask passes skip the per-element mask;
// - O leaves through shared memory (the dead Q rows) by TMA store.
// Semantics are the TPU kernel's: the soft cap is applied before the mask,
// masked logits take the finite fill -1e30 (in the natural domain, before
// the log2(e) scaling), and the loop bounds are the causal diagonal and
// the window start in C's truncating division, as jax.lax.div.
// GQA never materializes repeated K/V: query head h reads kv head h/(H/KV).
//
// Head dim 256 (flash_fwd_d256.cu, Gemma-2) is the same design with 64-key
// kv tiles: Q (64 KB) and two stages of K and V (2 x 64 KB) fill 192 KB of
// the 227 KB a block may have, where 128-key stages would need 320 KB. Rows
// are four swizzle atoms instead of two, S = Q K^T is m64n64 over 16
// k-steps, and O is two m64n128 accumulators (128 fp32 registers a thread).
//
// Head dim 192 (flash_fwd_d192.cu, DeepSeek's MLA, V zero-padded to the qk
// head dim by the model) is the 256 design at three atoms a row: 64-key
// tiles (Q 48 KB + two stages of K and V, 2 x 48 KB: 144 KB, where 128-key
// stages would need 240 KB), S = Q K^T m64n64 over 12 k-steps, and O one
// m64n192 accumulator (96 fp32 registers a thread). A third of the P V
// product's work lands on V's zero columns.
//
// Tile builds. TPUFW_BQ (query rows a block, 128 or 64: one consumer
// warpgroup per 64 rows) and TPUFW_BKV (keys a kv tile, 128 or 64) choose
// the tiles, defaulting to the ones above; each other tiling is a wrapper
// source of its own (flash_fwd_k64.cu: 128 x 64 at D = 128;
// flash_fwd_d192_q64.cu, flash_fwd_d256_q64.cu: 64 x 64), built into its
// own library with the same C function. At D = 192 and 256 the alternative
// is the 64-row query tile: a 32-key tile would fit (and need m64n32
// products), but the dK/dV kernel cannot take 32 keys (see flash_dkv.cu),
// so a 32-key override could never run a training step; 128-key K and V
// stages take 2 x 64 KB at D = 256 (48 KB at 192) each, so two of them
// beside Q pass the 227 KB a block may have, and one stage makes the next
// tile's copy wait for this tile's math.
// A 64-row block has one consumer warpgroup (256 threads) and half the
// query rows' work, so twice the blocks fill the card at small head counts.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace tpufw {
namespace fwd {

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
static_assert(BKV == 64 || BKV == 128, "S = Q K^T is one m64n64 or m64n128 product");
constexpr int STAGES = 2;                 // K/V ring depth
constexpr int CONSUMERS = BQ / 64;        // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer's warpgroup
// Register bound of every build: the 384-thread one's entry allocation
// (168), which setmaxnreg raises to CONSUMER_REGS, also at 256 threads.
constexpr int BOUND_THREADS = 384;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int NS = BKV / 2;   // S accumulator floats a thread (m64 x BKV)

constexpr int Q_ATOM = BQ * 128;    // 64 columns of the Q tile
constexpr int KV_ATOM = BKV * 128;  // 64 columns of a K or V tile
constexpr int Q_BYTES = ATOMS * Q_ATOM;
constexpr int KV_BYTES = ATOMS * KV_ATOM;
constexpr int Q_OFF = 0;
constexpr int K_OFF = Q_OFF + Q_BYTES;
constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
constexpr int KSEG_OFF = V_OFF + STAGES * KV_BYTES;  // int [STAGES][BKV]
constexpr int BAR_OFF = KSEG_OFF + STAGES * BKV * 4;
constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;  // + alignment
static_assert(SMEM <= 232448, "more shared memory than an H100 block may have");

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Raw scores of one kv tile -> base-2 logits, in place on the accumulator
// layout: cap(scale * raw) * log2(e), with the finite fill -1e30 (natural
// domain) where MASKED and a pair fails a mask. Templated so that neither
// the soft cap nor the mask costs a branch per element.
template <bool CAP, bool MASKED, int N>
__device__ __forceinline__ void tile_logits(float (&s)[N], const Masks& m, int k0,
                                            const int (&q_row)[2], const int (&qs)[2],
                                            const int* kseg_tile, int t4) {
  if (!CAP && !MASKED) {
    const float scale_log2 = m.scale * LOG2E;
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= scale_log2;
    return;
  }
  const float inv_cap = CAP ? 1.0f / m.cap : 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = s[i] * m.scale;
    if (CAP) x = m.cap * tanhf(x * inv_cap);
    if (MASKED) {
      const int col = (i / 4) * 8 + 2 * t4 + (i & 1), rh = (i >> 1) & 1;
      const int kpos = k0 + col;
      const int ks = m.kseg ? kseg_tile[col] : 0;
      if (!(kpos < m.S && visible(q_row[rh], kpos, qs[rh], ks, m))) x = NEG_INF;
    }
    s[i] = x * LOG2E;
  }
}

__global__ void __launch_bounds__(BOUND_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap, float* __restrict__ lse,
                 int H, int KV, Masks m) {
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
      mbar_arrive_expect_tx(bar_q, Q_BYTES);
      for (int a = 0; a < ATOMS; ++a)
        tma_load_4d(smem + Q_OFF + a * Q_ATOM, &qmap, bar_q, a * HALF_COLS, h, q0, b);
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

  // Consumers: warpgroup wg owns query rows [qw0, qw0 + 64).
  regs_alloc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, t4 = lane % 4;
  const int row = (tid / 32) * 16 + lane / 4;  // this thread's rows: row, row + 8
  const int qw0 = q0 + wg * 64;
  int q_row[2], qs[2] = {0, 0};
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    q_row[rh] = qw0 + row + 8 * rh;
    if (m.qseg && q_row[rh] < m.T) qs[rh] = m.qseg[(long)b * m.T + q_row[rh]];
  }
  float o[NO][OC / 2], s[NS];  // NO accumulators of OC columns (m64 x OC)
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int i = 0; i < OC / 2; ++i) o[c][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.0f;
  float m_row[2] = {NEG_INF * LOG2E, NEG_INF * LOG2E};  // running max, base 2
  float l_row[2] = {0.0f, 0.0f};  // this thread's share of the running sum

  const uint32_t q_base = smem_u32(smem + Q_OFF) + wg * 64 * 128;
  mbar_wait(bar_q, 0);
  for (int j = j0; j < j_hi; ++j) {
    const int n = j - j0, st = n % STAGES;
    const int k0 = j * BKV;
    const uint32_t k_base = smem_u32(smem + K_OFF + st * KV_BYTES);
    const uint32_t v_base = smem_u32(smem + V_OFF + st * KV_BYTES);
    mbar_wait(&full[st], (n / STAGES) & 1);

    // S = Q K^T: D/16 k-steps of 16 over D, K-major operands. The register
    // fences keep every write of an accumulator before its wgmma batch, so
    // the compiler cannot sink one into it (ptxas would then serialize).
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss_acc(s, make_desc(q_base + (kk / 4) * Q_ATOM + col, 16, 1024),
                   make_desc(k_base + (kk / 4) * KV_ATOM + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Logits in base 2; the mask only where some pair of the tile fails it.
    bool interior = m.qseg == nullptr && k0 + BKV <= m.S;
    if (m.causal) interior = interior && qw0 + m.offset >= k0 + BKV - 1;
    if (m.has_window) interior = interior && qw0 + 63 + m.offset - k0 < m.window;
    const int* kseg_tile = skseg + st * BKV;
    if (interior) {
      if (m.has_cap) tile_logits<true, false>(s, m, k0, q_row, qs, kseg_tile, t4);
      else tile_logits<false, false>(s, m, k0, q_row, qs, kseg_tile, t4);
    } else {
      if (m.has_cap) tile_logits<true, true>(s, m, k0, q_row, qs, kseg_tile, t4);
      else tile_logits<false, true>(s, m, k0, q_row, qs, kseg_tile, t4);
    }

    // Online softmax on the accumulator layout.
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      mx[rh] = quad_max(mx[rh]);
      alpha[rh] = fast_exp2(m_row[rh] - mx[rh]);
      m_row[rh] = mx[rh];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] = fast_exp2(s[i] - m_row[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) l_row[rh] = l_row[rh] * alpha[rh] + sum[rh];
#pragma unroll
    for (int c = 0; c < NO; ++c)
#pragma unroll
      for (int i = 0; i < OC / 2; ++i) o[c][i] *= alpha[(i >> 1) & 1];
    // P in bf16: the S accumulator layout is the A-fragment layout.
    uint32_t p[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    // O += P V: BKV/16 k-steps of 16 keys, V MN-major (atoms KV_ATOM
    // apart), one m64nOC product per OC columns of O.
#pragma unroll
    for (int c = 0; c < NO; ++c) fence_regs(o[c]);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < NO; ++c)
        wgmma_rs_tb(o[c], a,
                    make_desc(v_base + c * OC_ATOMS * KV_ATOM + kk * 16 * 128, KV_ATOM, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NO; ++c) fence_regs(o[c]);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // Epilogue: O = acc / l (l = 0 -> 1) in bf16 into this warpgroup's dead Q
  // rows, swizzled as the O map reads them, then one TMA store per atom.
  float inv[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float l = quad_sum(l_row[rh]);
    l = l == 0.0f ? 1.0f : l;
    inv[rh] = 1.0f / l;
    if (t4 == 0 && q_row[rh] < m.T)
      lse[((long)b * H + h) * m.T + q_row[rh]] = m_row[rh] * LN2 + logf(l);
  }
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
            pack_bf16(o[c][4 * n8 + 2 * rh] * inv[rh], o[c][4 * n8 + 2 * rh + 1] * inv[rh]);
      }
    }
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);
  if (tid == 0) {
    for (int a = 0; a < ATOMS; ++a)
      tma_store_4d(&omap, ob + a * Q_ATOM, a * HALF_COLS, h, qw0, b);
    tma_store_commit_and_wait();
  }
}

}  // namespace fwd
}  // namespace tpufw

// q [B,T,H,D], k/v [B,S,KV,D] bf16 (D of this build); o [B,T,H,D] bf16;
// lse [B,H,T] fp32;
// qseg [B,T] / kseg [B,S] int32 or null. Returns cudaGetLastError(), or
// cudaErrorInvalidValue when a tensor map cannot be encoded.
extern "C" int tpufw_flash_fwd(const void* q, const void* k, const void* v,
                               const void* qseg, const void* kseg, void* o,
                               void* lse, int B, int T, int S, int H, int KV,
                               int causal, int offset, int has_window,
                               int window, int has_cap, float cap,
                               void* stream) {
  using namespace tpufw::fwd;
  CUtensorMap qmap, kmap, vmap, omap;
  using tpufw::D;
  if (!tpufw::hopper::encode_rows_map(&qmap, q, B, T, H, BQ, D) ||
      !tpufw::hopper::encode_rows_map(&kmap, k, B, S, KV, BKV, D) ||
      !tpufw::hopper::encode_rows_map(&vmap, v, B, S, KV, BKV, D) ||
      !tpufw::hopper::encode_rows_map(&omap, o, B, T, H, 64, D))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM);
  const tpufw::Masks m = tpufw::make_masks(T, S, causal, offset, has_window, window, has_cap,
                             cap, qseg, kseg);
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, omap, static_cast<float*>(lse), H, KV, m);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of this build's block in bytes (ptxas reports only
// static shared memory; chip_smoke.py prints this beside its report).
extern "C" int tpufw_flash_fwd_smem() { return tpufw::fwd::SMEM; }
