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

#include "fp.cuh"

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

extern "C" int ripp_fp_cheap(int op, const void* a, const void* b, void* out,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  if (op < 1 || op > 3) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  fp_cheap_kernel<<<grid_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      op, (const int32_t*)a, (const int32_t*)b, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
