// A whole batched scalar multiplication (MSB-first double-and-add) in one
// launch, for G1 (over Fp) and G2 (over Fp2) alike.
//
// Replaces the Pallas kernel of FusedLadder._make_call in
// ripp_tpu/ops/curve_fused.py (reached from FusedLadder.scalar_mul_bits <-
// DevSWCurve.scalar_mul_bits). The field degree d comes from the programs:
// the state is the accumulator (X, Y, Z) in registers 0..3d-1 and the base
// point in 3d..6d-1 of the register file (layout and executor in
// kexec.cuh). The accumulator starts at the identity (0 : 1 : 0), 1 in
// Montgomery form. Per bit, as the TPU kernel does:
//   1. the doubling table (RCB15 doubling, ending with the copies of its
//      outputs to registers 0..3d-1);
//   2. the addition table (RCB15 complete addition of the base point);
//   3. on a set bit, the copy table moves the sum to registers 0..3d-1.
// The sum is computed on every bit and kept or dropped, so the doubling
// and addition tables run in step across a warp; only the short copy
// table (3d moves) runs under a branch on the element's bit, where the
// threads of a warp diverge when the bits differ per element. The output
// is bit-identical to the plain loop (ops/curve.py _scalar_mul_bits_impl).
//
// Input [3d][batch][NL] int32 (public layout), output the same.
// bits: uint8 0/1, bit i of element t at bits[i * bit_step + t * elem_step]:
// a shared scalar is [nbits] (bit_step 1, elem_step 0), one scalar an
// element is [nbits][batch] (bit_step batch, elem_step 1), so a warp reads
// one 32-byte line a bit.
//
// What bounds it: operations on paper (G1: 9 + 14 products a bit, 255 bits
// = 5,865 products an element, against about 0.3 KB of inputs and outputs),
// and within them latency: one thread carries one element through every
// product in sequence and the register file's traffic goes to L2, as in
// the fused Miller kernel. One-warp blocks spread a batch of a few
// thousand elements over all SMs. Splitting an element over several
// threads is later work. PERF.md has the measured times.

#include "kexec.cuh"

__global__ void ladder_kernel(const int* __restrict__ dbl_tab, int n_dbl,
                              const int* __restrict__ add_tab, int n_add,
                              const int* __restrict__ cp_tab, int n_cp,
                              const uint32_t* __restrict__ consts,
                              const uint8_t* __restrict__ bits, int nbits,
                              long long bit_step, long long elem_step, int d,
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
  // acc = (0 : 1 : 0): X = 0, Y = 1 (c0 = 1, c1 = 0 over Fp2), Z = 0
  for (int r = 0; r < 3 * d; r++)
    rf_store(regs, r, B, tid, r == d ? one : zero);
  // the base point
  for (int k = 0; k < 3 * d; k++) {
    load_elem(w, in + ((size_t)k * B + tid) * NL);
    rf_store(regs, 3 * d + k, B, tid, w);
  }
  const uint8_t* my_bits = bits + (size_t)(t * elem_step);
  for (int i = 0; i < nbits; i++) {
    exec_table(regs, B, tid, dbl_tab, n_dbl, consts);
    exec_table(regs, B, tid, add_tab, n_add, consts);
    if (__ldg(my_bits + (size_t)((long long)i * bit_step)))
      exec_table(regs, B, tid, cp_tab, n_cp, consts);
  }
  for (int k = 0; k < 3 * d; k++) {
    rf_load(w, regs, k, B, tid);
    store_elem(out + ((size_t)k * B + tid) * NL, w);
  }
}

extern "C" int ripp_ladder(const void* dbl_tab, int n_dbl, const void* add_tab,
                           int n_add, const void* cp_tab, int n_cp,
                           const void* consts, const void* bits, int nbits,
                           long long bit_step, long long elem_step, int d,
                           const void* in, void* out, void* regs,
                           long long batch, int threads, void* stream) {
  if (batch <= 0) return 0;
  if (threads <= 0 || threads > 1024 || nbits < 0 || (d != 1 && d != 2))
    return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)((batch + threads - 1) / threads);
  ladder_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)dbl_tab, n_dbl, (const int*)add_tab, n_add,
      (const int*)cp_tab, n_cp, (const uint32_t*)consts,
      (const uint8_t*)bits, nbits, bit_step, elem_step, d,
      (const int32_t*)in, (int32_t*)out, (uint32_t*)regs, batch);
  return (int)cudaGetLastError();
}
