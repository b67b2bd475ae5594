"""Executor for kprog field programs: a whole algebraic block as ONE CUDA
kernel launch with the registers in a scratch register file.

Counterpart of ripp_tpu/ops/kexec.py. `ProgramKernel` is the wrapper of
ripp_kexec (csrc/kexec.cu, csrc/kexec.cuh), which replaces the Pallas
kernel kernel_inner / _program_call and its exec_segments there.

Execution model on the card (the note in csrc/kexec.cuh says why):
  * one thread per batch element runs the program's flat instruction
    table in order: rows of (opcode, dst, a, b, m);
  * the register file is a scratch tensor in device memory laid out
    [n_regs][NL/2][batch] in 32-bit words, allocated by the wrapper;
  * the program's constants are a small table of Montgomery words.

`encode_table` turns a Scheduled program into that table; `decode_table`
turns it back (tests). `run_table` is the plain PyTorch version: it
interprets the SAME table with the plain field ops, so what the CPU tests
exercise is the encoding the kernel reads, not only the schedule.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .fp import LIMB_DTYPE, FieldSpec, int_to_limbs, limbs_tensor
from .kprog import Op, Scheduled

OP_MUL, OP_ADD, OP_SUB, OP_NEG, OP_SEL, OP_MOVC, OP_COPY = range(7)
_OPCODES = {"mul": OP_MUL, "add": OP_ADD, "sub": OP_SUB, "neg": OP_NEG,
            "sel": OP_SEL, "movc": OP_MOVC}
_KINDS = {v: k for k, v in _OPCODES.items()}
TAB_COLS = 5


def mul_table(sched: Scheduled) -> np.ndarray:
    """Concatenated (dst, a, b) rows of all mul groups, in segment order."""
    rows = []
    for kind, items in sched.segments:
        if kind == "muls":
            rows.extend(items)
    if not rows:
        return np.zeros((1, 3), dtype=np.int32)
    return np.asarray(rows, dtype=np.int32)


def encode_table(sched: Scheduled, const_base: int = 0) -> np.ndarray:
    """Scheduled program -> int32 [n_instr, 5] rows (opcode, dst, a, b, m)
    in execution order. A mul group becomes consecutive OP_MUL rows (its
    destinations never alias its operands, so running them in order is
    the group's barrier semantics). `const_base` is added to movc's
    constant index, for programs that share one constant table."""
    rows = []
    for kind, items in sched.segments:
        if kind == "muls":
            for d, a, b in items:
                rows.append((OP_MUL, d, a, b, -1))
            continue
        for op in items:
            if op.kind == "movc":
                rows.append((OP_MOVC, op.dst, op.a + const_base, -1, -1))
            else:
                rows.append((_OPCODES[op.kind], op.dst, op.a, op.b, op.m))
    return np.asarray(rows, dtype=np.int32).reshape(-1, TAB_COLS)


def decode_table(tab: np.ndarray, const_base: int = 0):
    """Inverse of encode_table: the segments list of a Scheduled."""
    segments = []
    for code, d, a, b, m in np.asarray(tab).tolist():
        if code == OP_MUL:
            if not segments or segments[-1][0] != "muls":
                segments.append(("muls", []))
            segments[-1][1].append((d, a, b))
            continue
        if not segments or segments[-1][0] != "ops":
            segments.append(("ops", []))
        if code == OP_MOVC:
            segments[-1][1].append(Op("movc", d, a=a - const_base))
        else:
            segments[-1][1].append(Op(_KINDS[code], d, a=a, b=b, m=m))
    return segments


def copy_rows(srcs: Sequence[int], dst0: int, n_regs: int):
    """OP_COPY rows moving registers `srcs` to dst0, dst0+1, ...; returns
    (rows, n_regs needed). Copies go straight across when no source lies
    in the destination range, else through temporaries above n_regs."""
    n = len(srcs)
    dsts = range(dst0, dst0 + n)
    if all(s not in dsts for s in srcs):
        rows = [(OP_COPY, d, s, -1, -1) for d, s in zip(dsts, srcs)]
        return np.asarray(rows, dtype=np.int32).reshape(-1, TAB_COLS), n_regs
    rows = [(OP_COPY, n_regs + k, s, -1, -1) for k, s in enumerate(srcs)]
    rows += [(OP_COPY, d, n_regs + k, -1, -1) for k, d in enumerate(dsts)]
    return np.asarray(rows, dtype=np.int32).reshape(-1, TAB_COLS), n_regs + n


def const_words(spec: FieldSpec, consts: Sequence[int]) -> np.ndarray:
    """Montgomery form of the program's constants as [n, NL/2] 32-bit
    words (int32 bit patterns), the register file's word layout."""
    nw = spec.nl // 2
    out = np.zeros((max(len(consts), 1), nw), dtype=np.uint32)
    for i, c in enumerate(consts):
        limbs = int_to_limbs((c % spec.p) * spec.r % spec.p, spec.nl)
        out[i] = limbs[0::2] | (limbs[1::2] << 16)
    return out.view(np.int32)


def const_limbs(spec: FieldSpec, consts: Sequence[int]) -> np.ndarray:
    """The same constants as [n, NL] 16-bit limbs (the public layout)."""
    return np.stack([
        int_to_limbs((c % spec.p) * spec.r % spec.p, spec.nl)
        for c in consts
    ]) if consts else np.zeros((0, spec.nl), dtype=np.uint32)


def run_table(fp, tab: np.ndarray, consts, regs: dict):
    """Plain PyTorch version of the kernels' executor: run the rows of an
    instruction table over a register dict {index: [batch, NL] tensor}
    (mask registers hold bool [batch] tensors, or field elements whose
    limb 0 is read). `consts` is a [n, NL] limb tensor. Updates and
    returns `regs`."""
    for code, d, a, b, m in np.asarray(tab).tolist():
        if code == OP_MUL:
            regs[d] = fp.mul(regs[a], regs[b])
        elif code == OP_ADD:
            regs[d] = fp.add(regs[a], regs[b])
        elif code == OP_SUB:
            regs[d] = fp.sub(regs[a], regs[b])
        elif code == OP_NEG:
            regs[d] = fp.neg(regs[a])
        elif code == OP_SEL:
            mk = regs[m]
            if mk.dtype != torch.bool:
                mk = mk[..., 0] > 0
            regs[d] = torch.where(mk.unsqueeze(-1), regs[a], regs[b])
        elif code == OP_MOVC:
            regs[d] = consts[a]
        elif code == OP_COPY:
            regs[d] = regs[a]
        else:
            raise ValueError(code)
    return regs


def block_threads(batch: int) -> int:
    """Threads a block for the register-machine kernels: one warp while
    the batch is small enough that wider blocks would leave SMs idle
    (a card has of the order of a hundred), four warps beyond."""
    return 32 if batch <= 32 * 1024 else 128


def regfile(n_regs: int, spec: FieldSpec, batch: int, device) -> torch.Tensor:
    """Scratch register file [n_regs, NL/2, batch] of 32-bit words."""
    return torch.empty((n_regs, spec.nl // 2, batch), dtype=torch.int32,
                       device=device)


def stack_inputs(spec: FieldSpec, inputs: Sequence[torch.Tensor], bshape):
    """[n][*bshape, NL] (broadcastable) -> contiguous [n, B, NL]."""
    full = tuple(bshape) + (spec.nl,)
    return torch.stack([x.expand(full).reshape(-1, spec.nl) for x in inputs])


class ProgramKernel:
    """Callable wrapper: run a scheduled program on [batch, NL] limb
    tensors (the public layout). CUDA tensors launch the kernel; CPU
    tensors (or plain=True) run the plain executor on the same table."""

    launches = 0  # class-wide count of ripp_kexec launches

    def __init__(self, fp, sched: Scheduled, plain: bool = False):
        self.fp = fp
        self.spec = fp.spec
        self.sched = sched
        self.plain = plain
        self.table = encode_table(sched)
        self._dev = {}

    def _device_tables(self, device):
        t = self._dev.get(device)
        if t is None:
            s = self.sched

            def ints(v):
                return torch.tensor(list(v) or [0], dtype=torch.int32,
                                    device=device)

            t = dict(
                tab=torch.from_numpy(self.table).to(device),
                consts=torch.from_numpy(
                    const_words(self.spec, s.consts)).to(device),
                in_regs=ints(s.inputs), mask_regs=ints(s.mask_inputs),
                out_regs=ints(s.outputs),
            )
            self._dev[device] = t
        return t

    def __call__(self, inputs: Sequence, masks: Sequence = ()):
        s = self.sched
        if len(inputs) != len(s.inputs) or len(masks) != len(s.mask_inputs):
            raise ValueError("wrong number of inputs or masks")
        bshape = torch.broadcast_shapes(*(x.shape[:-1] for x in inputs))
        if inputs[0].is_cuda and not self.plain:
            return self._launch(inputs, masks, bshape)
        regs = dict(zip(s.inputs, inputs))
        regs.update(zip(s.mask_inputs, masks))
        consts = limbs_tensor(const_limbs(self.spec, s.consts),
                              inputs[0].device)
        run_table(self.fp, self.table, consts, regs)
        nl = self.spec.nl
        return [regs[r].expand(tuple(bshape) + (nl,)) for r in s.outputs]

    def _launch(self, inputs, masks, bshape):
        from ..utils.build import load_library
        from .fp_cuda import check_launch, check_operand

        s, spec = self.sched, self.spec
        device = inputs[0].device
        for x in list(inputs) + list(masks):
            if x.device != device:
                raise ValueError(f"operands on {x.device} and {device}")
        in_arr = stack_inputs(spec, inputs, bshape)
        check_operand(spec, in_arr, "inputs")
        B = in_arr.shape[1]
        if masks:
            mask_arr = torch.stack([
                m.expand(bshape).reshape(-1).to(torch.int32) for m in masks])
        else:
            mask_arr = torch.zeros((1, 1), dtype=torch.int32, device=device)
        out = torch.empty((len(s.outputs), B, spec.nl), dtype=LIMB_DTYPE,
                          device=device)
        if B == 0:
            return [o.reshape(*bshape, spec.nl) for o in out]
        regs = regfile(s.n_regs, spec, B, device)
        t = self._device_tables(device)
        lib = load_library(spec)
        with torch.cuda.device(device):
            err = lib.ripp_kexec(
                t["tab"].data_ptr(), self.table.shape[0],
                t["consts"].data_ptr(),
                in_arr.data_ptr(), t["in_regs"].data_ptr(), len(s.inputs),
                mask_arr.data_ptr(), t["mask_regs"].data_ptr(),
                len(s.mask_inputs),
                out.data_ptr(), t["out_regs"].data_ptr(), len(s.outputs),
                regs.data_ptr(), B, block_threads(B),
                torch.cuda.current_stream().cuda_stream)
        check_launch(err, "ripp_kexec")
        ProgramKernel.launches += 1
        return [o.reshape(*bshape, spec.nl) for o in out]
