"""Fused double-and-add ladder: a whole batched scalar multiplication in
ONE kernel launch.

The accumulator, the base point and the bits stay in the kernel's
register file across all bits. The RCB15 complete add and double
formulas of ops/curve.py (eprint 2015/1060 algorithms 7 and 9, a = 0) are
traced into kprog programs op for op, so the kernel's outputs are
BIT-IDENTICAL to the plain loop (DevSWCurve._scalar_mul_bits_impl).
Generic over the base field's degree: G1 ladders run over Fp, G2 ladders
over Fp2 (the same programs traced over the symbolic tower).

Counterpart of ripp_tpu/ops/curve_fused.py. `FusedLadder` is the wrapper
of ripp_ladder (csrc/ladder.cu), which replaces the Pallas kernel of
FusedLadder._make_call there; that source's note says what bounds it on
the card. On the card this is the only route of scalar_mul_bits (the JAX
package's RIPP_FUSED_LADDER switch existed because of Mosaic compile
times); on CPU tensors the wrapper replays the kernel's own tables with
the plain field ops.
"""

from __future__ import annotations

import numpy as np
import torch

from .fp import LIMB_DTYPE, limbs_tensor
from .kexec import (
    block_threads,
    const_limbs,
    const_words,
    copy_rows,
    encode_table,
    regfile,
    run_table,
    stack_inputs,
)
from .kprog import KProg, prog_tower, schedule


def _build_point_progs(curve, group: str):
    """Trace RCB15 double and add programs for g1 (over Fp) or g2 (over
    the Fp2 twist). Pinned input layout: acc X,Y,Z (3d regs), base
    X2,Y2,Z2 (3d regs); outputs: new acc (3d)."""
    d = 1 if group == "g1" else 2

    def build(name, body):
        prog = KProg(name)
        fp, fp2, _, _, _ = prog_tower(prog, curve)
        F = fp if d == 1 else fp2

        def inp_el():
            if d == 1:
                return prog.inp()
            return (prog.inp(), prog.inp())

        acc = tuple(inp_el() for _ in range(3))
        base = tuple(inp_el() for _ in range(3))
        if group == "g1":
            b3 = F.const(3 * curve.g1.b % curve.p)
        else:
            b3h = curve.tower.fp2.mul_int(curve.g2.b, 3)
            b3 = (fp.const(b3h[0]), fp.const(b3h[1]))
        out = body(F, b3, acc, base)
        flat = []
        for el in out:
            flat.extend(el if d == 2 else [el])
        prog.out(flat)
        return schedule(prog, pin_inputs=True)

    def dbl_body(F, b3, acc, base):
        # ops/curve.py DevSWCurve.double, same op structure
        X, Y, Z = acc
        t0 = F.mul(Y, Y)
        t1 = F.mul(Y, Z)
        t2m = F.mul(Z, Z)
        txy = F.mul(X, Y)
        z3a = F.add(t0, t0)
        z3a = F.add(z3a, z3a)
        z3a = F.add(z3a, z3a)
        t2 = F.mul(b3, t2m)
        y3a = F.add(t0, t2)
        t0b = F.sub(t0, F.add(F.add(t2, t2), t2))
        x3m = F.mul(t2, z3a)
        y3m = F.mul(t0b, y3a)
        z3 = F.mul(t1, z3a)
        x3b = F.mul(t0b, txy)
        return (F.add(x3b, x3b), F.add(x3m, y3m), z3)

    def add_body(F, b3, acc, base):
        # ops/curve.py DevSWCurve.add (RCB15 complete, a = 0)
        X1, Y1, Z1 = acc
        X2, Y2, Z2 = base
        m_xx = F.mul(X1, X2)
        m_yy = F.mul(Y1, Y2)
        m_zz = F.mul(Z1, Z2)
        m_xy = F.mul(F.add(X1, Y1), F.add(X2, Y2))
        m_yz = F.mul(F.add(Y1, Z1), F.add(Y2, Z2))
        m_xz = F.mul(F.add(X1, Z1), F.add(X2, Z2))
        t3 = F.sub(m_xy, F.add(m_xx, m_yy))
        t4 = F.sub(m_yz, F.add(m_yy, m_zz))
        ty = F.sub(m_xz, F.add(m_xx, m_zz))
        t0 = F.add(F.add(m_xx, m_xx), m_xx)
        t2 = F.mul(b3, m_zz)
        y3b = F.mul(b3, ty)
        z3s = F.add(m_yy, t2)
        t1s = F.sub(m_yy, t2)
        p_a = F.mul(t4, y3b)
        p_b = F.mul(t3, t1s)
        p_c = F.mul(y3b, t0)
        p_d = F.mul(t1s, z3s)
        p_e = F.mul(t0, t3)
        p_f = F.mul(z3s, t4)
        return (F.sub(p_b, p_a), F.add(p_d, p_c), F.add(p_f, p_e))

    return (build(f"{group}_dbl", dbl_body), build(f"{group}_add", add_body))


class FusedLadder:
    """One-launch double-and-add ladder for one group of a DevCurveCtx."""

    # launches of ripp_ladder, by group
    launches = {"g1": 0, "g2": 0}

    def __init__(self, ctx, group: str):
        self.ctx = ctx
        self.group = group
        self.fp = ctx.t.fp
        self.spec = ctx.t.spec_fp
        self.d = 1 if group == "g1" else 2
        self.dbl_sched, self.add_sched = _build_point_progs(ctx.host, group)
        dbl_s, add_s = self.dbl_sched, self.add_sched
        n_state = 3 * self.d
        assert dbl_s.inputs == add_s.inputs == list(range(2 * n_state))
        assert len(dbl_s.outputs) == len(add_s.outputs) == n_state
        # doubling table = program + copies of its outputs to the
        # accumulator (always kept); addition table = program; copy table
        # = the sum's copies to the accumulator, run on a set bit only.
        # One constant table for both programs.
        self.consts = list(dbl_s.consts) + list(add_s.consts)
        n_regs = max(dbl_s.n_regs, add_s.n_regs)
        dbl_cp, n1 = copy_rows(dbl_s.outputs, 0, n_regs)
        add_cp, n2 = copy_rows(add_s.outputs, 0, n_regs)
        self.n_regs = max(n1, n2)
        self.dbl_table = np.concatenate([encode_table(dbl_s), dbl_cp])
        self.add_table = encode_table(add_s, const_base=len(dbl_s.consts))
        self.copy_table = add_cp
        self._dev = {}

    def _flat(self, P):
        flat = []
        for coord in P:
            flat.extend(coord if self.d == 2 else [coord])
        return flat

    def _nest(self, rows):
        if self.d == 1:
            return (rows[0], rows[1], rows[2])
        return ((rows[0], rows[1]), (rows[2], rows[3]), (rows[4], rows[5]))

    def scalar_mul_bits(self, P, bits):
        """Same contract as DevSWCurve.scalar_mul_bits (bit-identical):
        P a projective tree, bits [nbits] (shared, MSB first) or
        [batch..., nbits] (one scalar an element). CUDA tensors take one
        launch of the kernel; CPU tensors replay the same tables with the
        plain field ops."""
        flat = self._flat(P)
        if flat[0].is_cuda:
            return self._nest(self._launch(flat, bits))
        return self._nest(self._replay(flat, bits))

    def _replay(self, flat, bits):
        """Plain version of the kernel: its own tables, run with
        run_table over the bits."""
        fp = self.fp
        n = 3 * self.d
        bshape = torch.broadcast_shapes(*(x.shape[:-1] for x in flat))
        full = tuple(bshape) + (self.spec.nl,)
        one = fp.one().expand(full)
        zero = torch.zeros(full, dtype=LIMB_DTYPE, device=flat[0].device)
        acc = [one if k == self.d else zero for k in range(n)]
        regs = dict(enumerate(acc + [x.expand(full) for x in flat]))
        consts = limbs_tensor(const_limbs(self.spec, self.consts),
                              flat[0].device)
        shared = bits.dim() == 1
        for i in range(bits.shape[-1]):
            run_table(fp, self.dbl_table, consts, regs)
            run_table(fp, self.add_table, consts, regs)
            keep = dict(regs)
            run_table(fp, self.copy_table, consts, keep)
            mask = (bits[i] if shared else bits[..., i]) > 0
            for k in range(n):
                regs[k] = torch.where(mask.unsqueeze(-1), keep[k], regs[k])
        return [regs[k] for k in range(n)]

    def _device_tables(self, device):
        t = self._dev.get(device)
        if t is None:
            t = dict(
                dbl=torch.from_numpy(self.dbl_table).to(device),
                add=torch.from_numpy(self.add_table).to(device),
                cp=torch.from_numpy(self.copy_table).to(device),
                consts=torch.from_numpy(
                    const_words(self.spec, self.consts)).to(device),
            )
            self._dev[device] = t
        return t

    def _launch(self, flat, bits):
        from ..utils.build import load_library
        from .fp_cuda import check_launch, check_operand

        spec = self.spec
        device = flat[0].device
        for x in list(flat) + [bits]:
            if x.device != device:
                raise ValueError(f"operands on {x.device} and {device}")
        bshape = torch.broadcast_shapes(*(x.shape[:-1] for x in flat))
        in_arr = stack_inputs(spec, flat, bshape)
        check_operand(spec, in_arr, "inputs")
        B = in_arr.shape[1]
        nbits = bits.shape[-1]
        if bits.dim() == 1:
            bit_arr = bits.to(torch.uint8).contiguous()
            bit_step, elem_step = 1, 0
        else:
            if tuple(bits.shape[:-1]) != tuple(bshape):
                raise ValueError(
                    f"bits {tuple(bits.shape)} do not match the batch "
                    f"{tuple(bshape)}")
            # [nbits, B]: a warp reads one line a bit
            bit_arr = bits.reshape(B, nbits).t().to(torch.uint8).contiguous()
            bit_step, elem_step = B, 1
        out = torch.empty((3 * self.d, B, spec.nl), dtype=LIMB_DTYPE,
                          device=device)
        if B:
            regs = regfile(self.n_regs, spec, B, device)
            t = self._device_tables(device)
            lib = load_library(spec)
            with torch.cuda.device(device):
                err = lib.ripp_ladder(
                    t["dbl"].data_ptr(), self.dbl_table.shape[0],
                    t["add"].data_ptr(), self.add_table.shape[0],
                    t["cp"].data_ptr(), self.copy_table.shape[0],
                    t["consts"].data_ptr(), bit_arr.data_ptr(), nbits,
                    bit_step, elem_step, self.d,
                    in_arr.data_ptr(), out.data_ptr(), regs.data_ptr(),
                    B, block_threads(B),
                    torch.cuda.current_stream().cuda_stream)
            check_launch(err, "ripp_ladder")
            FusedLadder.launches[self.group] += 1
        return [o.reshape(*bshape, spec.nl) for o in out]


_LADDERS = {}


def fused_ladder(ctx, group: str) -> FusedLadder:
    """Cached per (context, group); a context is per curve, device and
    plain flag, and the entry holds it, so its id cannot be reused."""
    key = (id(ctx), group)
    if key not in _LADDERS:
        _LADDERS[key] = FusedLadder(ctx, group)
    return _LADDERS[key]
