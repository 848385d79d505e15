// Shared pieces of the flash-attention kernels: the mask semantics
// (Masks, make_masks, visible, capped_logit), used by all three, and the
// wmma tiles of the dQ kernel (flash_bwd.cu).
//
// dQ tiles: 64 query rows x 64 key rows, head dim 128, four warps per
// block, each warp owning 16 rows of the block's tile. Products run on the
// tensor cores through wmma bf16 16x16x16 fragments with fp32 accumulation;
// the softmax statistics and masks are fp32 scalar code over shared memory.
// The forward and dK/dV kernels use the Hopper pieces of hopper.cuh instead.
//
// Masks follow tpufw/ops/flash.py exactly: query row i sits at absolute key
// position offset + i; a key is visible when it is a real key (k < S), not
// in the future (causal), within the window (q_pos - k_pos < window) and in
// the same segment. The soft cap cap*tanh(x/cap) is applied to the scaled
// logits before the mask, and masked logits take the finite fill -1e30.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tpufw {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int D = 128;        // head dim
constexpr int BQ = 64;        // query rows per tile
constexpr int BKV = 64;       // key rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

// Shared-memory row strides, padded against bank conflicts. Every wmma
// pointer (row multiple of 16, column multiple of 16) stays 32-byte aligned.
constexpr int LDH = D + 8;    // bf16 [rows][D] tiles
constexpr int LDS = BKV + 4;  // fp32 [64][64] score tiles
constexpr int LDP = BKV + 8;  // bf16 [64][64] probability tiles
constexpr int LDO = D + 4;    // fp32 [64][D] accumulators

constexpr int TILE_H_BYTES = 64 * LDH * 2;  // 17408
constexpr int TILE_S_BYTES = 64 * LDS * 4;  // 17408
constexpr int TILE_P_BYTES = 64 * LDP * 2;  // 9216
constexpr int TILE_O_BYTES = 64 * LDO * 4;  // 33792

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Masks {
  int T, S;        // query and key lengths
  int causal;
  int offset;      // absolute key position of query row 0
  int has_window, window;
  int has_cap;
  float cap;
  float scale;     // 1/sqrt(D)
  const int* qseg; // [B, T] or null
  const int* kseg; // [B, S] or null
};

// Copies rows [row0, row0 + 64) of a [N][D] bf16 slab whose rows are
// `row_stride` elements apart into a [64][LDH] shared tile; rows >= n_valid
// become zeros, so padding keys carry zero K and V as in the TPU kernel.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int n_valid, long row_stride) {
  for (int i = threadIdx.x; i < 64 * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid)
      val = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// out[16 x 64] (fp32, stride LDS) = A[16 x D] * B[64 x D]^T for one warp:
// A rows from `a` (stride LDH), B rows from `b` (stride LDH).
__device__ __forceinline__ void warp_abt(float* out, const bf16* a, const bf16* b) {
  FragC acc[BKV / 16];
#pragma unroll
  for (int n = 0; n < BKV / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, LDH);
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, b + n * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BKV / 16; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], LDS, wmma::mem_row_major);
}

// acc[n] (16 x D as D/16 fragments) += P[16 x 64] (stride LDP) * B[64 x D]
// (stride LDH), for one warp.
__device__ __forceinline__ void warp_pb(FragC* acc, const bf16* p, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + kk, LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// cap(scale * raw): the logit every kernel masks and exponentiates.
__device__ __forceinline__ float capped_logit(float raw, const Masks& m) {
  const float x = raw * m.scale;
  return m.has_cap ? m.cap * tanhf(x / m.cap) : x;
}

// Causal, window and segment terms for (query row q_row, key k). Key
// padding and query padding are the caller's, as in each TPU kernel.
__device__ __forceinline__ bool visible(int q_row, int k, int qseg, int kseg,
                                        const Masks& m) {
  const int q_pos = q_row + m.offset;
  bool ok = true;
  if (m.causal) ok = ok && q_pos >= k;
  if (m.has_window) ok = ok && (q_pos - k) < m.window;
  if (m.qseg) ok = ok && qseg == kseg;
  return ok;
}

// kv tiles [j0, j_hi) a query tile can see: the causal diagonal bounds the
// end and the window the start (tpufw/ops/flash.py:165-173, :90-99). C's
// truncating division matches jax.lax.div.
__device__ __forceinline__ void kv_range(int qt, const Masks& m, int* j0, int* j_hi) {
  const int n_kv = (m.S + BKV - 1) / BKV;
  *j_hi = n_kv;
  if (m.causal) {
    const int n_needed = ((qt + 1) * BQ + m.offset + BKV - 1) / BKV;
    *j_hi = min(n_needed, n_kv);
  }
  *j0 = 0;
  if (m.has_window) *j0 = max((qt * BQ + m.offset - m.window + 1) / BKV, 0);
}

inline Masks make_masks(int T, int S, int causal, int offset, int has_window,
                        int window, int has_cap, float cap, const void* qseg,
                        const void* kseg) {
  Masks m;
  m.T = T;
  m.S = S;
  m.causal = causal;
  m.offset = offset;
  m.has_window = has_window;
  m.window = window;
  m.has_cap = has_cap;
  m.cap = cap;
  m.scale = 1.0f / sqrtf((float)D);
  m.qseg = static_cast<const int*>(qseg);
  m.kseg = static_cast<const int*>(kseg);
  return m;
}

}  // namespace tpufw
