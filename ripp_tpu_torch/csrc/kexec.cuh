// The register machine: one thread runs one batch element through the flat
// instruction table of a scheduled field program (ops/kexec.py encode_table).
// The program kernel (kexec.cu), the fused Miller loop (miller.cu), the
// fused ladder (ladder.cu) and the fused GT exponentiation (gtexp.cu) all
// run their tables through exec_table below.
//
// Replaces exec_segments / read_reg / write_reg of ripp_tpu/ops/kexec.py.
// There the register file was a VMEM scratch [n_regs, NL, 8, 128] and each
// group of independent products ran as a loop over an SMEM (dst, a, b)
// table, because a fully unrolled product per multiplication was too much
// code. Here every instruction, cheap or product, is a row of one table and
// the thread runs them in order, so the groups need no special handling and
// the kernel's code is one copy of each op.
//
// Where the register file lives: up to ~160 registers of 4*NW bytes are
// about 7.6 KB an element at 381 bits, too much for hardware registers and
// for more than ~29 elements of an SM's shared memory. It is a scratch
// tensor in device memory laid out [n_regs][NW][batch], so that the threads
// of a warp touch neighbouring words (one 128-byte line a word); at 2048 to
// 4096 elements it is 16 to 31 MB and stays in the 50 MB L2.
//
// A row is 5 ints: opcode, dst, a, b, m. For OP_MOVC `a` indexes the table
// of constants ([n_consts][NW] Montgomery words); for OP_SEL `m` is the mask
// register, of which the low 16-bit limb is read, as the reference reads
// limb 0.

#pragma once

#include "fp.cuh"

enum {
  OP_MUL = 0, OP_ADD = 1, OP_SUB = 2, OP_NEG = 3, OP_SEL = 4, OP_MOVC = 5,
  OP_COPY = 6
};

#define TAB_COLS 5

__device__ __forceinline__ void rf_load(uint32_t w[NW], const uint32_t* regs,
                                        int r, size_t batch, size_t tid) {
  const uint32_t* base = regs + (size_t)r * NW * batch + tid;
#pragma unroll
  for (int k = 0; k < NW; k++) w[k] = base[(size_t)k * batch];
}

__device__ __forceinline__ void rf_store(uint32_t* regs, int r, size_t batch,
                                         size_t tid, const uint32_t w[NW]) {
  uint32_t* base = regs + (size_t)r * NW * batch + tid;
#pragma unroll
  for (int k = 0; k < NW; k++) base[(size_t)k * batch] = w[k];
}

static __device__ __noinline__ void exec_table(uint32_t* regs, size_t batch,
                                        size_t tid, const int* __restrict__ tab,
                                        int n_instr,
                                        const uint32_t* __restrict__ consts) {
  for (int i = 0; i < n_instr; i++) {
    const int* row = tab + (size_t)i * TAB_COLS;
    const int op = __ldg(row), dst = __ldg(row + 1), ra = __ldg(row + 2),
              rb = __ldg(row + 3), rm = __ldg(row + 4);
    uint32_t x[NW], y[NW], z[NW];
    switch (op) {
      case OP_MUL:
        rf_load(x, regs, ra, batch, tid);
        rf_load(y, regs, rb, batch, tid);
        mont_mul(z, x, y);
        break;
      case OP_ADD:
        rf_load(x, regs, ra, batch, tid);
        rf_load(y, regs, rb, batch, tid);
        fp_add(z, x, y);
        break;
      case OP_SUB:
        rf_load(x, regs, ra, batch, tid);
        rf_load(y, regs, rb, batch, tid);
        fp_sub(z, x, y);
        break;
      case OP_NEG:
        rf_load(x, regs, ra, batch, tid);
        fp_neg(z, x);
        break;
      case OP_SEL: {
        const uint32_t mk = regs[(size_t)rm * NW * batch + tid] & 0xFFFFu;
        rf_load(x, regs, ra, batch, tid);
        rf_load(y, regs, rb, batch, tid);
        fp_sel(z, mk != 0, x, y);
        break;
      }
      case OP_MOVC:
#pragma unroll
        for (int k = 0; k < NW; k++) z[k] = __ldg(consts + (size_t)ra * NW + k);
        break;
      default:  // OP_COPY
        rf_load(z, regs, ra, batch, tid);
        break;
    }
    rf_store(regs, dst, batch, tid, z);
  }
}
