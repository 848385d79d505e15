// The mask semantics shared by the three flash-attention kernels (Masks,
// make_masks, visible) and the kv loop bounds of the forward and dQ
// kernels (kv_tiles). The Hopper building blocks are in hopper.cuh.
//
// The head dim D is fixed per build: 128 by default, 192 or 256 where a
// source defines TPUFW_HEAD_DIM before including this (the *_d192.cu
// sources, DeepSeek's MLA; the *_d256.cu sources, Gemma-2). Each kernel
// derives its tiles from D.
//
// Masks follow tpufw/ops/flash.py exactly: query row i sits at absolute key
// position offset + i; a key is visible when it is a real key (k < S), not
// in the future (causal), within the window (q_pos - k_pos < window) and in
// the same segment. The soft cap cap*tanh(x/cap) is applied to the scaled
// logits before the mask, and masked logits take the finite fill -1e30.

#pragma once

#include <cuda_runtime.h>

namespace tpufw {

#ifndef TPUFW_HEAD_DIM
#define TPUFW_HEAD_DIM 128
#endif
constexpr int D = TPUFW_HEAD_DIM;  // head dim of this build
static_assert(D == 128 || D == 192 || D == 256,
              "the flash kernels take head dim 128, 192 or 256");
constexpr int ATOMS = D / 64;  // 128-byte swizzle atoms (64 bf16 columns) a row
// Columns of one O, dQ, dK or dV accumulator (one register-A wgmma per
// k-step): 128 at D = 128 and 256 (one or two m64n128), 192 at D = 192
// (one m64n192: three atoms, where 128-column chunks would leave 64 over).
constexpr int OC = D == 192 ? 192 : 128;
constexpr int NO = D / OC;         // accumulators of that width a row
constexpr int OC_ATOMS = OC / 64;  // swizzle atoms one accumulator spans
constexpr float NEG_INF = -1e30f;

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

// kv tiles [j0, j_hi) of BKV keys that query tile qt of BQ rows can see:
// the causal diagonal bounds the end and the window the start
// (tpufw/ops/flash.py:230-235, :90). C's truncating division matches
// jax.lax.div. Mirrors flash.py:fwd_kv_tiles (dq_kv_tiles is the same
// function), which tests/test_torch_flash_tiles.py checks on the CPU: an
// edit here must be made there too.
template <int BQ, int BKV>
__device__ __forceinline__ void kv_tiles(int qt, const Masks& m, int* j0, int* j_hi) {
  const int n_kv = (m.S + BKV - 1) / BKV;
  *j_hi = n_kv;
  if (m.causal) *j_hi = min(((qt + 1) * BQ + m.offset + BKV - 1) / BKV, n_kv);
  *j0 = m.has_window ? max((qt * BQ + m.offset - m.window + 1) / BKV, 0) : 0;
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
  // 1/sqrt(D): at D = 192 that is MLA's qk_head_dim**-0.5, because the
  // model zero-pads V from 128 to the qk head dim (the pad adds nothing).
  m.scale = 1.0f / sqrtf((float)D);
  m.qseg = static_cast<const int*>(qseg);
  m.kseg = static_cast<const int*>(kseg);
  return m;
}

}  // namespace tpufw
