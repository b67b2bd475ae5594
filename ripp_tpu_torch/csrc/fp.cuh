// Shared device functions for one prime field: Montgomery product and the
// cheap ring ops, one thread per field element.
//
// Replaces the shared kernel bodies of the JAX package: mont_mul_limbs
// (ripp_tpu/ops/fp_pallas.py) and k_add / k_sub / k_neg / k_sel /
// k_cond_sub_p (ripp_tpu/ops/kexec.py). Semantics are theirs exactly:
// every input and output is canonical (< p), so results are equal limb for
// limb and not merely congruent mod p.
//
// Form on this card: an element is FP_NW = NL/2 32-bit words held in
// hardware registers (NL is a multiple of 4, so R = 2^(16*NL) = 2^(32*FP_NW)
// and the Montgomery form is the same as with 16-bit limbs). The product is
// word-serial CIOS with 64-bit accumulators, fully unrolled; nvcc lowers
// each step to a 32x32->64 multiply-add with carry. The modulus, -p^-1 mod
// 2^32 and R mod p come from the generated fp_config.h as macros, so they
// are immediates / constant-bank operands.
//
// Public layout (what crosses a kernel's boundary): [batch, NL] int32, one
// 16-bit limb per int32, element-major. load_elem / store_elem convert
// with 16-byte vector accesses; a row is 4*NL bytes, a multiple of 16.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_config.h"

#define NW FP_NW
#define NL (2 * FP_NW)

static __device__ __constant__ uint32_t FP_P[NW] = {FP_P_WORDS};
static __device__ __constant__ uint32_t FP_ONE[NW] = {FP_ONE_WORDS};

// r = (t >= p) ? t - p : t, or t - p whenever `force` is set (t < 2p).
__device__ __forceinline__ void fp_cond_sub_p(uint32_t r[NW],
                                              const uint32_t t[NW],
                                              bool force) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    uint64_t v = (uint64_t)t[k] - FP_P[k] - borrow;
    d[k] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  bool geq = force || (borrow == 0);
#pragma unroll
  for (int k = 0; k < NW; k++) r[k] = geq ? d[k] : t[k];
}

// r = a * b * R^-1 mod p (CIOS), canonical in and out.
__device__ __forceinline__ void mont_mul(uint32_t r[NW], const uint32_t a[NW],
                                         const uint32_t b[NW]) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int k = 0; k < NW + 2; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint64_t c = 0;
    const uint32_t bi = b[i];
#pragma unroll
    for (int j = 0; j < NW; j++) {
      uint64_t x = (uint64_t)a[j] * bi + t[j] + c;
      t[j] = (uint32_t)x;
      c = x >> 32;
    }
    uint64_t x = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)x;
    t[NW + 1] = (uint32_t)(x >> 32);

    const uint32_t m = t[0] * (uint32_t)FP_N0;
    x = (uint64_t)m * FP_P[0] + t[0];
    c = x >> 32;
#pragma unroll
    for (int j = 1; j < NW; j++) {
      x = (uint64_t)m * FP_P[j] + t[j] + c;
      t[j - 1] = (uint32_t)x;
      c = x >> 32;
    }
    x = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)x;
    t[NW] = t[NW + 1] + (uint32_t)(x >> 32);
  }
  // t < 2p; p has a headroom bit so t[NW] is 0, but honour it all the same
  fp_cond_sub_p(r, t, t[NW] != 0);
}

// r = (a + b) mod p: p is subtracted when the sum carried out or is >= p.
__device__ __forceinline__ void fp_add(uint32_t r[NW], const uint32_t a[NW],
                                       const uint32_t b[NW]) {
  uint32_t s[NW];
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    uint64_t v = (uint64_t)a[k] + b[k] + c;
    s[k] = (uint32_t)v;
    c = (uint32_t)(v >> 32);
  }
  fp_cond_sub_p(r, s, c != 0);
}

// r = (a - b) mod p: p is added back when a < b.
__device__ __forceinline__ void fp_sub(uint32_t r[NW], const uint32_t a[NW],
                                       const uint32_t b[NW]) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    uint64_t v = (uint64_t)a[k] - b[k] - borrow;
    d[k] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const bool under = borrow != 0;
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    uint64_t v = (uint64_t)d[k] + FP_P[k] + c;
    r[k] = under ? (uint32_t)v : d[k];
    c = (uint32_t)(v >> 32);
  }
}

// r = (-a) mod p: p - a, with 0 passed through.
__device__ __forceinline__ void fp_neg(uint32_t r[NW], const uint32_t a[NW]) {
  uint32_t nz = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) nz |= a[k];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < NW; k++) {
    uint64_t v = (uint64_t)FP_P[k] - a[k] - borrow;
    r[k] = nz ? (uint32_t)v : 0u;
    borrow = (uint32_t)(v >> 63);
  }
}

// r = m ? a : b
__device__ __forceinline__ void fp_sel(uint32_t r[NW], bool m,
                                       const uint32_t a[NW],
                                       const uint32_t b[NW]) {
#pragma unroll
  for (int k = 0; k < NW; k++) r[k] = m ? a[k] : b[k];
}

// One element of the public layout (NL int32, a 16-bit limb in each) ->
// NW packed words. `row` must be 16-byte aligned.
__device__ __forceinline__ void load_elem(uint32_t w[NW], const int32_t* row) {
  const int4* v4 = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int k = 0; k < NW / 2; k++) {
    const int4 v = v4[k];
    w[2 * k] = ((uint32_t)v.x & 0xFFFFu) | ((uint32_t)v.y << 16);
    w[2 * k + 1] = ((uint32_t)v.z & 0xFFFFu) | ((uint32_t)v.w << 16);
  }
}

__device__ __forceinline__ void store_elem(int32_t* row, const uint32_t w[NW]) {
  int4* v4 = reinterpret_cast<int4*>(row);
#pragma unroll
  for (int k = 0; k < NW / 2; k++) {
    int4 v;
    v.x = (int32_t)(w[2 * k] & 0xFFFFu);
    v.y = (int32_t)(w[2 * k] >> 16);
    v.z = (int32_t)(w[2 * k + 1] & 0xFFFFu);
    v.w = (int32_t)(w[2 * k + 1] >> 16);
    v4[k] = v;
  }
}
