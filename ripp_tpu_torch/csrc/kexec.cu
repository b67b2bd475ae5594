// One scheduled field program over a batch in one launch.
//
// Replaces the Pallas kernel kernel_inner / _program_call of
// ripp_tpu/ops/kexec.py (reached from ProgramKernel.__call__). Inputs are
// [n_in][batch][NL] int32 in the public layout, masks [n_mask][batch]
// int32 (0 or 1), outputs [n_out][batch][NL]; the register file is scratch
// that the wrapper allocates (see kexec.cuh for its layout and why).
//
// What bounds it: on paper the bytes of its inputs and outputs (each read
// or written once) take a little longer than its integer operations; in
// fact neither does, latency does. A thread runs its element's whole
// program in order (54 dependent-ish products for an Fp12 product), the
// register file's traffic goes to L2, and a batch of a few thousand
// elements gives an SM one warp. What the design does about it: blocks
// are one warp while the batch is small, so that a few thousand elements
// still spread over all the SMs, and the register file is word-major so a
// warp's access is one 128-byte line. Splitting an element over several
// threads is later work. PERF.md has the measured times.

#include "kexec.cuh"

__global__ void kexec_kernel(const int* __restrict__ tab, int n_instr,
                             const uint32_t* __restrict__ consts,
                             const int32_t* __restrict__ in,
                             const int* __restrict__ in_regs, int n_in,
                             const int32_t* __restrict__ masks,
                             const int* __restrict__ mask_regs, int n_mask,
                             int32_t* __restrict__ out,
                             const int* __restrict__ out_regs, int n_out,
                             uint32_t* regs, long long batch) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch) return;
  const size_t B = (size_t)batch, tid = (size_t)t;
  uint32_t w[NW];
  for (int k = 0; k < n_in; k++) {
    load_elem(w, in + ((size_t)k * B + tid) * NL);
    rf_store(regs, __ldg(in_regs + k), B, tid, w);
  }
  for (int k = 0; k < n_mask; k++) {
    const uint32_t m = (uint32_t)masks[(size_t)k * B + tid];
#pragma unroll
    for (int j = 0; j < NW; j++) w[j] = m;
    rf_store(regs, __ldg(mask_regs + k), B, tid, w);
  }
  exec_table(regs, B, tid, tab, n_instr, consts);
  for (int k = 0; k < n_out; k++) {
    rf_load(w, regs, __ldg(out_regs + k), B, tid);
    store_elem(out + ((size_t)k * B + tid) * NL, w);
  }
}

extern "C" int ripp_kexec(const void* tab, int n_instr, const void* consts,
                          const void* in, const void* in_regs, int n_in,
                          const void* masks, const void* mask_regs, int n_mask,
                          void* out, const void* out_regs, int n_out,
                          void* regs, long long batch, int threads,
                          void* stream) {
  if (batch <= 0) return 0;
  if (threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)((batch + threads - 1) / threads);
  kexec_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)tab, n_instr, (const uint32_t*)consts, (const int32_t*)in,
      (const int*)in_regs, n_in, (const int32_t*)masks, (const int*)mask_regs,
      n_mask, (int32_t*)out, (const int*)out_regs, n_out, (uint32_t*)regs,
      batch);
  return (int)cudaGetLastError();
}
