// Batched GT exponentiation g^e (MSB-first square and multiply) in one
// launch.
//
// Replaces the Pallas kernel of FusedGtExp._call / make in
// ripp_tpu/ops/pairing_fused.py (reached from FusedGtExp.__call__ <-
// DevPairing.gt_exp_batch). Registers 0..11 of the register file hold the
// accumulator (starting at 1), 12..23 hold g. Per exponent bit the mask
// registers of the step program are set from the element's bit and the
// step table runs: acc <- bit ? acc^2 * g : acc^2 (the program's `sel`
// rows pick, so every element runs the same rows), ending with the copies
// of its 12 outputs to registers 0..11. The executor is kexec.cuh's, the
// one the program kernel runs (including its `sel`, which reads the low
// 16-bit limb of the mask register).
//
// Input [12][batch][NL] int32 (public layout), output the same; bits uint8
// [nbits][batch], 0/1, first bit highest.
//
// What bounds it: operations on paper (90 products and about 440 cheap ops
// a bit, 255 bits: about 23k products an element against 2.3 KB of inputs
// and outputs), and within them latency: the verifier's batch is
// 2*log2(n) elements (24 at n = 4096), one warp on one SM, each thread
// carrying its element through every product in sequence. Splitting an
// element's independent products (groups of 36 and 54) over the threads
// of a warp is later work. PERF.md has the measured times.

#include "kexec.cuh"

__global__ void gtexp_kernel(const int* __restrict__ tab, int n_instr,
                             const uint32_t* __restrict__ consts,
                             const int* __restrict__ mask_regs, int n_mask,
                             const uint8_t* __restrict__ bits, int nbits,
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
  // acc = 1 in Fp12; g from the input
  rf_store(regs, 0, B, tid, one);
  for (int r = 1; r < 12; r++) rf_store(regs, r, B, tid, zero);
  for (int k = 0; k < 12; k++) {
    load_elem(w, in + ((size_t)k * B + tid) * NL);
    rf_store(regs, 12 + k, B, tid, w);
  }
  for (int i = 0; i < nbits; i++) {
    const uint32_t m = __ldg(bits + (size_t)i * B + tid);
#pragma unroll
    for (int k = 0; k < NW; k++) w[k] = m;
    for (int k = 0; k < n_mask; k++)
      rf_store(regs, __ldg(mask_regs + k), B, tid, w);
    exec_table(regs, B, tid, tab, n_instr, consts);
  }
  for (int k = 0; k < 12; k++) {
    rf_load(w, regs, k, B, tid);
    store_elem(out + ((size_t)k * B + tid) * NL, w);
  }
}

extern "C" int ripp_gtexp(const void* tab, int n_instr, const void* consts,
                          const void* mask_regs, int n_mask, const void* bits,
                          int nbits, const void* in, void* out, void* regs,
                          long long batch, int threads, void* stream) {
  if (batch <= 0) return 0;
  if (threads <= 0 || threads > 1024 || nbits < 0)
    return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)((batch + threads - 1) / threads);
  gtexp_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)tab, n_instr, (const uint32_t*)consts,
      (const int*)mask_regs, n_mask, (const uint8_t*)bits, nbits,
      (const int32_t*)in, (int32_t*)out, (uint32_t*)regs, batch);
  return (int)cudaGetLastError();
}
