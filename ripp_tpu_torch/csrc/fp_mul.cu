// Batched Montgomery product, and the batched cheap ring ops.
//
// ripp_fp_mul replaces the Pallas kernel _mul_kernel / _mul_call of
// ripp_tpu/ops/fp_pallas.py (reached from fp_mul <- DevFp.mul). One thread
// per element: load both operands from the public element-major layout
// with 16-byte vector loads, mont_mul in registers, store.
//
// What bounds it on this card: bytes. The function moves 3 * 4*NL bytes an
// element (the public layout spends an int32 on each 16-bit limb) and does
// about 2*NW^2 + NW word multiply-adds; for a 381-bit field that is 288
// bytes against about 300 multiply-adds, and at the card's rates the bytes
// take longer. The design keeps the element-major public layout: a thread
// reads whole 32-byte sectors of its own row with 16-byte vector loads, so
// no sector is fetched twice, and no transposes are needed around the
// call (the TPU kernel needed one each way). Packing two limbs a word in
// the public layout would halve the bytes; that is a change of the
// package's layout, not of this kernel. PERF.md has the measured times.
//
// ripp_fp_cheap (add / sub / neg over a batch) has no Pallas counterpart:
// the JAX package left those to XLA. Here they are thin launches of the
// shared device functions so that the tower code between kernels is one
// launch an op instead of a ripple of small tensor ops. Bound by bytes.
//
// ripp_fp_mul_hybrid8 replaces the Pallas kernel _mul_kernel_hybrid of
// ripp_tpu/ops/fp_pallas.py (the "hybrid8" variant of _mul_call). It
// computes the same canonical a*b*R^-1 mod p as ripp_fp_mul, by the
// reference's method rather than by word-serial CIOS: the 2*NL bytes of a
// times the NL 16-bit limbs of b go straight into 4*NL-2 accumulators at
// byte positions (a product of a byte and a limb is below 2^24, so it
// needs no hi/lo split), then NL reduction rounds at radix 2^16 with m
// split into its two bytes, then a byte carry ripple and one conditional
// subtraction. One thread an element, like ripp_fp_mul, and the same bytes
// bound it. The method saved the TPU's vector unit its hi/lo splits; this
// card multiplies 32 x 32 -> 64 natively, so here it costs more: 4*NL^2
// 32-bit multiply-adds (2304 for Fp) against CIOS's 2*NW^2 + NW word
// products (300), and 94 accumulators live for Fp (62 for Fr), so the
// operations and register pressure, not the memory, may make it the
// slower of the two. It is kept simple and right; PERF.md has both times.

#include "fp.cuh"

// 16-bit limb j of a packed element (two limbs a word).
__device__ __forceinline__ uint32_t limb16(const uint32_t w[NW], int j) {
  return (w[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
}

// r = a * b * R^-1 mod p by the 8x16 hybrid method, canonical in and out.
//
// Why uint32 accumulators do not overflow: byte position k receives at
// most NL schoolbook products (byte i2 of a times limb j of b lands on
// k = i2 + 2j: one j for each of the NL bytes i2 of k's parity) and at
// most NL reduction products (one a round, m's low byte on even and its
// high byte on odd positions), each below 2^8 * 2^16 = 2^24, plus one
// shifted-out carry below 2^24. For NL = 24 that is below 49 * 2^24 <
// 2^29.7 (the reference's bound is 2^30.7 for NL <= 48).
//
// Why the shifted-out carry is exact: after round k adds m*p, the 16-bit
// group at byte positions o = 2k, o+1 is 0 mod 2^16, i.e. acc[o] +
// 2^8 acc[o+1] = 2^16 K; then acc[o] is 0 mod 2^8 and
// K = ((acc[o] >> 8) + acc[o+1]) >> 8 with nothing lost.
__device__ __forceinline__ void mont_mul_hybrid8(uint32_t r[NW],
                                                 const uint32_t a[NW],
                                                 const uint32_t b[NW]) {
  constexpr int NA = 4 * NL - 2;
  uint32_t acc[NA];
#pragma unroll
  for (int k = 0; k < NA; k++) acc[k] = 0;
#pragma unroll
  for (int i2 = 0; i2 < 2 * NL; i2++) {
    const uint32_t ai = (a[i2 >> 2] >> (8 * (i2 & 3))) & 0xFFu;
#pragma unroll
    for (int j = 0; j < NL; j++) acc[i2 + 2 * j] += ai * limb16(b, j);
  }
  const uint32_t n0 = (uint32_t)FP_N0 & 0xFFFFu;  // -p^-1 mod 2^16
#pragma unroll
  for (int k = 0; k < NL; k++) {
    const int o = 2 * k;  // the shift by one 16-bit group is this offset
    const uint32_t t16 = (acc[o] + ((acc[o + 1] & 0xFFu) << 8)) & 0xFFFFu;
    const uint32_t m16 = (t16 * n0) & 0xFFFFu;
    const uint32_t mlo = m16 & 0xFFu, mhi = m16 >> 8;
#pragma unroll
    for (int j = 0; j < NL; j++) {
      const uint32_t pj = limb16(FP_P, j);
      acc[o + 2 * j] += mlo * pj;
      acc[o + 2 * j + 1] += mhi * pj;
    }
    acc[o + 2] += ((acc[o] >> 8) + acc[o + 1]) >> 8;
  }
  // U = (a*b + m*p) / R < 2p sits in bytes 2*NL .. 4*NL-3 (and two empty
  // ones above); ripple the byte carries into packed words. The carry out
  // of the top byte is 0 because U < 2p < R.
  uint32_t u[NW];
#pragma unroll
  for (int k = 0; k < NW; k++) u[k] = 0;
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < 2 * NL; k++) {
    const int idx = 2 * NL + k;
    const uint32_t v = (idx < NA ? acc[idx] : 0u) + c;
    u[k >> 2] |= (v & 0xFFu) << (8 * (k & 3));
    c = v >> 8;
  }
  fp_cond_sub_p(r, u, false);
}

__global__ void fp_mul_kernel(const int32_t* __restrict__ a,
                              const int32_t* __restrict__ b,
                              int32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NW], y[NW], z[NW];
  load_elem(x, a + i * NL);
  load_elem(y, b + i * NL);
  mont_mul(z, x, y);
  store_elem(out + i * NL, z);
}

__global__ void fp_mul_hybrid8_kernel(const int32_t* __restrict__ a,
                                      const int32_t* __restrict__ b,
                                      int32_t* __restrict__ out,
                                      long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NW], y[NW], z[NW];
  load_elem(x, a + i * NL);
  load_elem(y, b + i * NL);
  mont_mul_hybrid8(z, x, y);
  store_elem(out + i * NL, z);
}

// op: 1 add, 2 sub, 3 neg (the executor's opcodes)
__global__ void fp_cheap_kernel(int op, const int32_t* __restrict__ a,
                                const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NW], y[NW], z[NW];
  load_elem(x, a + i * NL);
  if (op == 3) {
    fp_neg(z, x);
  } else {
    load_elem(y, b + i * NL);
    if (op == 1) fp_add(z, x, y);
    else fp_sub(z, x, y);
  }
  store_elem(out + i * NL, z);
}

static inline unsigned int grid_for(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

extern "C" int ripp_fp_mul(const void* a, const void* b, void* out,
                           long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  fp_mul_kernel<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int ripp_fp_mul_hybrid8(const void* a, const void* b, void* out,
                                   long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  fp_mul_hybrid8_kernel<<<grid_for(n, threads), threads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int ripp_fp_cheap(int op, const void* a, const void* b, void* out,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  if (op < 1 || op > 3) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  fp_cheap_kernel<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      op, (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
