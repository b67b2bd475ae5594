// The whole batched Miller loop f_{|x|,Q}(P) in one launch.
//
// Replaces the Pallas kernel of FusedMiller._call / make in
// ripp_tpu/ops/pairing_fused.py (reached from FusedMiller.miller <-
// DevPairing.miller_batch). State lives in registers 0..23 of the register
// file: f (12), T = (X, Y, Z) (6), Q = (qx, qy) (4), P = (xP, yP) (2). It is
// initialised to f = 1, T = (qx, qy, 1); for each bit of |x| after the top
// one the doubling table runs, and on a set bit the addition table; each
// table ends with the copies of its 18 outputs back to registers 0..17
// (the encoder appends them). Registers 0..11 are written out.
//
// Input [6][batch][NL] int32: qx.c0, qx.c1, qy.c0, qy.c1, xP, yP.
// Output [12][batch][NL]: the Fp12 value in flat tower order.
// `bits` holds the nbits (<= 64) loop bits, first bit highest.
//
// What bounds it: operations on paper (about 7.7k products and 30k cheap
// ops a pair against 1.7 KB of inputs and outputs), and within them
// latency: one thread carries one pair through all of them in sequence,
// and a batch of a few thousand pairs gives each SM only a warp, so the
// time hardly depends on the batch up to 4096 pairs. The design answers
// the part it can: one launch for the whole loop, the state never leaves
// the register file, and one-warp blocks spread a small batch over all
// SMs. Splitting an element over several threads is later work. PERF.md
// has the measured times.

#include "kexec.cuh"

__global__ void miller_kernel(const int* __restrict__ dbl_tab, int n_dbl,
                              const int* __restrict__ add_tab, int n_add,
                              const uint32_t* __restrict__ consts,
                              unsigned long long bits, int nbits,
                              const int32_t* __restrict__ in,
                              int32_t* __restrict__ out, uint32_t* regs,
                              long long batch) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch) return;
  const size_t B = (size_t)batch, tid = (size_t)t;
  uint32_t w[NW], one[NW], zero[NW];
#pragma unroll
  for (int k = 0; k < NW; k++) {
    one[k] = FP_ONE[k];
    zero[k] = 0;
  }
  // f = 1
  rf_store(regs, 0, B, tid, one);
  for (int r = 1; r < 12; r++) rf_store(regs, r, B, tid, zero);
  // X, Y = qx, qy (12..15); Q = qx, qy (18..21); P = xP, yP (22, 23)
  for (int k = 0; k < 6; k++) {
    load_elem(w, in + ((size_t)k * B + tid) * NL);
    if (k < 4) rf_store(regs, 12 + k, B, tid, w);
    rf_store(regs, 18 + k, B, tid, w);
  }
  // Z = 1 in Fp2
  rf_store(regs, 16, B, tid, one);
  rf_store(regs, 17, B, tid, zero);

  for (int i = 0; i < nbits; i++) {
    exec_table(regs, B, tid, dbl_tab, n_dbl, consts);
    if ((bits >> (nbits - 1 - i)) & 1ull)
      exec_table(regs, B, tid, add_tab, n_add, consts);
  }
  for (int k = 0; k < 12; k++) {
    rf_load(w, regs, k, B, tid);
    store_elem(out + ((size_t)k * B + tid) * NL, w);
  }
}

extern "C" int ripp_miller(const void* dbl_tab, int n_dbl, const void* add_tab,
                           int n_add, const void* consts,
                           unsigned long long bits, int nbits, const void* in,
                           void* out, void* regs, long long batch, int threads,
                           void* stream) {
  if (batch <= 0) return 0;
  if (threads <= 0 || threads > 1024 || nbits < 0 || nbits > 64)
    return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)((batch + threads - 1) / threads);
  miller_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)dbl_tab, n_dbl, (const int*)add_tab, n_add,
      (const uint32_t*)consts, bits, nbits, (const int32_t*)in, (int32_t*)out,
      (uint32_t*)regs, batch);
  return (int)cudaGetLastError();
}
