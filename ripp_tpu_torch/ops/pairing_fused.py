"""Fused Miller loop: the whole batched loop in ONE kernel launch.

The Miller accumulator f, the running point T and the pair inputs stay in
the kernel's register file across all steps of the loop.

The doubling/addition step formulas are traced into kprog programs from
the SAME math as ops/pairing.py (CLN-style combined doubling+line,
eprint 2010/526 family; sparse 13/14-product line multiplication;
RCB15 complete addition from ops/curve.py for the T update), op for op,
so the fused kernel's Miller values are BIT-IDENTICAL to the plain loop
(DevPairing._miller_impl) and differentially testable against it.

Counterpart of ripp_tpu/ops/pairing_fused.py. `FusedMiller` is the
wrapper of ripp_miller (csrc/miller.cu), which replaces the Pallas kernel
of FusedMiller._call there; that source's note says what bounds it on the
card. `FusedGtExp` is the wrapper of ripp_gtexp (csrc/gtexp.cu), which
replaces the Pallas kernel of FusedGtExp._call: the whole batched GT
exponentiation in one launch, with the step program of
`_build_gtexp_prog`.
"""

from __future__ import annotations

import numpy as np
import torch

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
from .fp import LIMB_DTYPE, limbs_tensor
from .kprog import KProg, prog_tower, schedule
from .tower import tree_leaves


def _build_step_progs(curve):
    """Trace the Miller doubling and addition step programs.

    Both programs declare the SAME pinned input layout so the kernel can
    keep protocol state in the input registers between steps:
      f (12 Fp), X, Y, Z (6 Fp as 3 Fp2), qx, qy (4 Fp), xP, yP (2 Fp).
    Outputs: new f (12), new X, Y, Z (6).
    """

    def declare(prog):
        f = tuple(
            tuple(tuple(prog.inp() for _ in range(2)) for _ in range(3))
            for _ in range(2)
        )
        X = (prog.inp(), prog.inp())
        Y = (prog.inp(), prog.inp())
        Z = (prog.inp(), prog.inp())
        qx = (prog.inp(), prog.inp())
        qy = (prog.inp(), prog.inp())
        xP = prog.inp()
        yP = prog.inp()
        return f, X, Y, Z, qx, qy, xP, yP

    twist = curve.twist_type

    def line_coeffs(t, fp, F2, mul_xi, cy_yP, cx_xP, c0):
        # ops/pairing.py _line_coeffs_post_eval
        if twist == "D":
            return (cy_yP, cx_xP, c0)
        return (mul_xi(cy_yP), c0, cx_xP)

    def mul_by_line(F2, F6, mul_xi, f, coeffs):
        """ops/pairing.py _mul_by_line, same sub-product structure."""
        nr = mul_xi
        f0, f1 = f
        f00, f01, f02 = f0
        f10, f11, f12 = f1
        if twist == "D":
            a0, a1, a3 = coeffs
            s01 = F2.add(f10, f11)
            b01 = F2.add(a1, a3)
            g0, g1, g2_ = F2.add(f00, f10), F2.add(f01, f11), F2.add(f02, f12)
            c01 = F2.add(a0, a1)
            sg01 = F2.add(g0, g1)
            v00 = F2.mul(f00, a0)
            v01 = F2.mul(f01, a0)
            v02 = F2.mul(f02, a0)
            m0 = F2.mul(f10, a1)
            m1 = F2.mul(f11, a3)
            tt = F2.mul(s01, b01)
            p4 = F2.mul(f12, a3)
            p5 = F2.mul(f12, a1)
            n0 = F2.mul(g0, c01)
            n1 = F2.mul(g1, a3)
            nt = F2.mul(sg01, F2.add(c01, a3))
            n4 = F2.mul(g2_, a3)
            n5 = F2.mul(g2_, c01)
            v1 = (
                F2.add(m0, nr(p4)),
                F2.sub(F2.sub(tt, m0), m1),
                F2.add(p5, m1),
            )
            w_ = (
                F2.add(n0, nr(n4)),
                F2.sub(F2.sub(nt, n0), n1),
                F2.add(n5, n1),
            )
            v0 = (v00, v01, v02)
        else:
            a0, a3, a5 = coeffs
            s12 = F2.add(f11, f12)
            b12 = F2.add(a3, a5)
            g0, g1, g2_ = F2.add(f00, f10), F2.add(f01, f11), F2.add(f02, f12)
            v00 = F2.mul(f00, a0)
            v01 = F2.mul(f01, a0)
            v02 = F2.mul(f02, a0)
            m1 = F2.mul(f11, a3)
            m2 = F2.mul(f12, a5)
            tt = F2.mul(s12, b12)
            p1 = F2.mul(f10, a3)
            p2 = F2.mul(f10, a5)
            w0 = F2.mul(g0, a0)
            w1 = F2.mul(g1, a3)
            w2 = F2.mul(g2_, a5)
            t01 = F2.mul(F2.add(g0, g1), F2.add(a0, a3))
            t02 = F2.mul(F2.add(g0, g2_), F2.add(a0, a5))
            t12 = F2.mul(F2.add(g1, g2_), b12)
            v1 = (
                nr(F2.sub(F2.sub(tt, m1), m2)),
                F2.add(p1, nr(m2)),
                F2.add(p2, m1),
            )
            v0 = (v00, v01, v02)
            w_ = (
                F2.add(w0, nr(F2.sub(F2.sub(t12, w1), w2))),
                F2.add(F2.sub(F2.sub(t01, w0), w1), nr(w2)),
                F2.add(F2.sub(F2.sub(t02, w0), w2), w1),
            )
        c0_ = tuple(
            F2.add(v, mv)
            for v, mv in zip(v0, (nr(v1[2]), v1[0], v1[1]))
        )  # v0 + nr6 * v1 (F6.mul_by_x then F6.add)
        c1_ = tuple(F2.sub(F2.sub(w, v), u) for w, v, u in zip(w_, v0, v1))
        return (c0_, c1_)

    def fp2_mul_small(F2, fp, a, k):
        return (fp.mul_small(a[0], k), fp.mul_small(a[1], k))

    def fp2_scale_fp(F2, fp, a, s):
        return (fp.mul(a[0], s), fp.mul(a[1], s))

    # 3*b' twist constant as a host fp2 tuple (ops/points.py:34)
    b3h = curve.tower.fp2.mul_int(curve.g2.b, 3)

    # ---- doubling step program ----------------------------------------------
    dbl = KProg("miller_dbl")
    fp, F2, F6, F12, mul_xi = prog_tower(dbl, curve)
    f, X, Y, Z, qx, qy, xP, yP = declare(dbl)
    b3 = (fp.const(b3h[0]), fp.const(b3h[1]))
    f = F12.sqr(f)
    B = F2.mul(Y, Y)
    C = F2.mul(Z, Z)
    A = F2.mul(X, Y)
    X2 = F2.mul(X, X)
    YZ2 = F2.mul(F2.add(Y, Z), F2.add(Y, Z))
    Zb = F2.mul(Z, b3)
    H = F2.sub(F2.sub(YZ2, B), C)
    cy = F2.neg(H)
    cx = fp2_mul_small(F2, fp, X2, 3)
    E = F2.mul(Zb, Z)
    cy_yP = fp2_scale_fp(F2, fp, cy, yP)
    cx_xP = fp2_scale_fp(F2, fp, cx, xP)
    F_ = fp2_mul_small(F2, fp, E, 3)
    G = F2.add(B, F_)
    c0 = F2.sub(E, B)
    AX = F2.mul(A, F2.sub(B, F_))
    GG = F2.mul(G, G)
    EE = F2.mul(E, E)
    BH = F2.mul(B, H)
    X3 = fp2_mul_small(F2, fp, AX, 2)
    Y3 = F2.sub(GG, fp2_mul_small(F2, fp, EE, 12))
    Z3 = fp2_mul_small(F2, fp, BH, 4)
    f = mul_by_line(F2, F6, mul_xi,
                    f, line_coeffs(None, fp, F2, mul_xi, cy_yP, cx_xP, c0))
    dbl.out([x for h in f for p2 in h for x in p2]
            + list(X3) + list(Y3) + list(Z3))

    # ---- addition step program ----------------------------------------------
    add = KProg("miller_add")
    fp, F2, F6, F12, mul_xi = prog_tower(add, curve)
    f, X, Y, Z, qx, qy, xP, yP = declare(add)
    b3 = (fp.const(b3h[0]), fp.const(b3h[1]))
    qyZ = F2.mul(qy, Z)
    qxZ = F2.mul(qx, Z)
    theta = F2.sub(Y, qyZ)
    lam = F2.sub(X, qxZ)
    tqx = F2.mul(theta, qx)
    lqy = F2.mul(lam, qy)
    cy_yP = fp2_scale_fp(F2, fp, lam, yP)
    cx_xP = fp2_scale_fp(F2, fp, F2.neg(theta), xP)
    c0 = F2.sub(tqx, lqy)
    f = mul_by_line(F2, F6, mul_xi,
                    f, line_coeffs(None, fp, F2, mul_xi, cy_yP, cx_xP, c0))
    # RCB15 complete addition with Q = (qx, qy, 1) (ops/curve.py add)
    one2 = (fp.one(), fp.zero())
    X1, Y1, Z1 = X, Y, Z
    X2_, Y2_, Z2_ = qx, qy, one2
    m_xx = F2.mul(X1, X2_)
    m_yy = F2.mul(Y1, Y2_)
    m_zz = F2.mul(Z1, Z2_)
    m_xy = F2.mul(F2.add(X1, Y1), F2.add(X2_, Y2_))
    m_yz = F2.mul(F2.add(Y1, Z1), F2.add(Y2_, Z2_))
    m_xz = F2.mul(F2.add(X1, Z1), F2.add(X2_, Z2_))
    t3 = F2.sub(m_xy, F2.add(m_xx, m_yy))
    t4 = F2.sub(m_yz, F2.add(m_yy, m_zz))
    ty = F2.sub(m_xz, F2.add(m_xx, m_zz))
    t0 = F2.add(F2.add(m_xx, m_xx), m_xx)
    t2 = F2.mul(b3, m_zz)
    y3b = F2.mul(b3, ty)
    z3s = F2.add(m_yy, t2)
    t1s = F2.sub(m_yy, t2)
    p_a = F2.mul(t4, y3b)
    p_b = F2.mul(t3, t1s)
    p_c = F2.mul(y3b, t0)
    p_d = F2.mul(t1s, z3s)
    p_e = F2.mul(t0, t3)
    p_f = F2.mul(z3s, t4)
    X3 = F2.sub(p_b, p_a)
    Y3 = F2.add(p_d, p_c)
    Z3 = F2.add(p_f, p_e)
    add.out([x for h in f for p2 in h for x in p2]
            + list(X3) + list(Y3) + list(Z3))

    return (schedule(dbl, pin_inputs=True),
            schedule(add, pin_inputs=True))


class FusedMiller:
    """One-launch batched Miller loop for a DevCurveCtx's curve."""

    launches = 0  # class-wide count of ripp_miller launches

    # shared state register layout (== pinned input registers):
    # f 12, X/Y/Z 6, qx/qy 4, xP/yP 2
    N_STATE = 24
    N_OUT = 18

    def __init__(self, ctx):
        self.ctx = ctx
        host = ctx.host
        self.fp = ctx.t.fp
        self.spec = ctx.t.spec_fp
        self.x_bits = tuple(int(b) for b in bin(abs(host.x))[3:])
        if len(self.x_bits) > 64:
            raise ValueError("loop parameter longer than 64 bits")
        self.dbl_sched, self.add_sched = _build_step_progs(host)
        dbl_s, add_s = self.dbl_sched, self.add_sched
        # dbl and add share the input-register layout by construction
        assert dbl_s.inputs == add_s.inputs == list(range(self.N_STATE))
        assert len(dbl_s.outputs) == len(add_s.outputs) == self.N_OUT
        # each table = the step program, then its outputs copied back to
        # the state registers 0..17; one constant table for both
        self.consts = list(dbl_s.consts) + list(add_s.consts)
        n_regs = max(dbl_s.n_regs, add_s.n_regs)
        dbl_cp, n1 = copy_rows(dbl_s.outputs, 0, n_regs)
        add_cp, n2 = copy_rows(add_s.outputs, 0, n_regs)
        self.n_regs = max(n1, n2)
        self.dbl_table = np.concatenate([encode_table(dbl_s), dbl_cp])
        self.add_table = np.concatenate(
            [encode_table(add_s, const_base=len(dbl_s.consts)), add_cp])
        self._dev = {}

    def miller(self, xP, yP, qx, qy):
        """Batched Miller f_{|x|,Q}(P): same contract as
        DevPairing._miller_impl (bit-identical output). CUDA tensors take
        one launch of the kernel; CPU tensors (or a plain context) replay
        the same tables with the plain field ops."""
        if xP.is_cuda and not self.ctx.plain:
            rows = self._launch(xP, yP, qx, qy)
        else:
            rows = self._replay(xP, yP, qx, qy)
        # fp12 flat order: ((0,1),(2,3),(4,5)), ((6,7),(8,9),(10,11))
        return (
            ((rows[0], rows[1]), (rows[2], rows[3]), (rows[4], rows[5])),
            ((rows[6], rows[7]), (rows[8], rows[9]), (rows[10], rows[11])),
        )

    def _replay(self, xP, yP, qx, qy):
        """Plain version of the kernel: the kernel's own tables, run with
        run_table over the loop's bits."""
        fp = self.fp
        one = fp.one().expand(xP.shape)
        zero = torch.zeros_like(xP)
        state = ([one] + [zero] * 11
                 + [qx[0], qx[1], qy[0], qy[1], one, zero]
                 + [qx[0], qx[1], qy[0], qy[1], xP, yP])
        regs = dict(enumerate(state))
        consts = limbs_tensor(const_limbs(self.spec, self.consts), xP.device)
        for b in self.x_bits:
            run_table(fp, self.dbl_table, consts, regs)
            if b:
                run_table(fp, self.add_table, consts, regs)
        return [regs[k] for k in range(12)]

    def _device_tables(self, device):
        t = self._dev.get(device)
        if t is None:
            t = dict(
                dbl=torch.from_numpy(self.dbl_table).to(device),
                add=torch.from_numpy(self.add_table).to(device),
                consts=torch.from_numpy(
                    const_words(self.spec, self.consts)).to(device),
            )
            self._dev[device] = t
        return t

    def _launch(self, xP, yP, qx, qy):
        from ..utils.build import load_library
        from .fp_cuda import check_launch, check_operand

        spec = self.spec
        device = xP.device
        ins = [qx[0], qx[1], qy[0], qy[1], xP, yP]
        for x in ins:
            if x.device != device:
                raise ValueError(f"operands on {x.device} and {device}")
        bshape = torch.broadcast_shapes(*(x.shape[:-1] for x in ins))
        in_arr = stack_inputs(spec, ins, bshape)
        check_operand(spec, in_arr, "inputs")
        B = in_arr.shape[1]
        out = torch.empty((12, B, spec.nl), dtype=LIMB_DTYPE, device=device)
        if B:
            regs = regfile(self.n_regs, spec, B, device)
            t = self._device_tables(device)
            bits = 0
            for b in self.x_bits:
                bits = (bits << 1) | b
            lib = load_library(spec)
            with torch.cuda.device(device):
                err = lib.ripp_miller(
                    t["dbl"].data_ptr(), self.dbl_table.shape[0],
                    t["add"].data_ptr(), self.add_table.shape[0],
                    t["consts"].data_ptr(), bits, len(self.x_bits),
                    in_arr.data_ptr(), out.data_ptr(), regs.data_ptr(),
                    B, block_threads(B),
                    torch.cuda.current_stream().cuda_stream)
            check_launch(err, "ripp_miller")
            FusedMiller.launches += 1
        return [o.reshape(*bshape, spec.nl) for o in out]


_FUSED = {}


def fused_miller(ctx) -> FusedMiller:
    """Cached per context (a context is per curve, device and plain flag;
    it is held by the entry so its id cannot be reused)."""
    key = id(ctx)
    if key not in _FUSED:
        _FUSED[key] = FusedMiller(ctx)
    return _FUSED[key]


# ---------------------------------------------------------------------------
# Fused GT exponentiation
# ---------------------------------------------------------------------------

def _build_gtexp_prog(curve):
    """One GT square-and-multiply step: acc' = bit ? acc^2 * g : acc^2.

    Traced once into the kprog IR. Input layout is pinned (acc 12, g 12
    in registers 0..23) so the looped kernel can keep both resident in
    the register file across all exponent bits."""
    prog = KProg(curve.name + ".gtexp_step")
    fp, fp2, fp6, fp12, _ = prog_tower(prog, curve)

    def decl12():
        return tuple(
            tuple(tuple(prog.inp() for _ in range(2)) for _ in range(3))
            for _ in range(2)
        )

    acc = decl12()
    g = decl12()
    bit = prog.mask_inp()
    sq = fp12.sqr(acc)
    wm = fp12.mul(sq, g)
    outs = []
    for i in range(2):
        for j in range(3):
            for k in range(2):
                outs.append(prog.sel(bit, wm[i][j][k], sq[i][j][k]))
    prog.out(outs)
    return schedule(prog, pin_inputs=True)


class FusedGtExp:
    """One-launch batched GT exponentiation.

    Call with (f_tree, bits): f_tree an Fp12 tree of [k, NL] leaves, bits
    a [k, nbits] 0/1 tensor, MSB first. Returns the Fp12 tree of f^e,
    bit-identical to the plain square and multiply of
    DevPairing.gt_exp_batch. CUDA tensors take one launch of the kernel;
    CPU tensors replay the same table with the plain field ops."""

    launches = 0  # class-wide count of ripp_gtexp launches

    def __init__(self, ctx):
        self.ctx = ctx
        self.fp = ctx.t.fp
        self.spec = ctx.t.spec_fp
        self.sched = _build_gtexp_prog(ctx.host)
        s = self.sched
        assert s.inputs == list(range(24)) and len(s.outputs) == 12
        # the step program, then its outputs copied to registers 0..11
        cp, self.n_regs = copy_rows(s.outputs, 0, s.n_regs)
        self.table = np.concatenate([encode_table(s), cp])
        self._dev = {}

    def __call__(self, f_tree, bits):
        leaves = tree_leaves(f_tree)
        if leaves[0].is_cuda:
            rows = self._launch(leaves, bits)
        else:
            rows = self._replay(leaves, bits)
        return (
            ((rows[0], rows[1]), (rows[2], rows[3]), (rows[4], rows[5])),
            ((rows[6], rows[7]), (rows[8], rows[9]), (rows[10], rows[11])),
        )

    def _replay(self, leaves, bits):
        """Plain version of the kernel: its own table, run with run_table
        over the bits."""
        fp = self.fp
        g = leaves[0]
        one = fp.one().expand(g.shape)
        zero = torch.zeros_like(g)
        regs = dict(enumerate([one] + [zero] * 11 + list(leaves)))
        consts = limbs_tensor(const_limbs(self.spec, self.sched.consts),
                              g.device)
        for i in range(bits.shape[-1]):
            for mr in self.sched.mask_inputs:
                regs[mr] = bits[:, i] > 0
            run_table(fp, self.table, consts, regs)
        return [regs[k] for k in range(12)]

    def _device_tables(self, device):
        t = self._dev.get(device)
        if t is None:
            s = self.sched
            t = dict(
                tab=torch.from_numpy(self.table).to(device),
                consts=torch.from_numpy(
                    const_words(self.spec, s.consts)).to(device),
                mask_regs=torch.tensor(s.mask_inputs, dtype=torch.int32,
                                       device=device),
            )
            self._dev[device] = t
        return t

    def _launch(self, leaves, bits):
        from ..utils.build import load_library
        from .fp_cuda import check_launch, check_operand

        spec = self.spec
        device = leaves[0].device
        for x in list(leaves) + [bits]:
            if x.device != device:
                raise ValueError(f"operands on {x.device} and {device}")
        B, nbits = bits.shape
        in_arr = stack_inputs(spec, leaves, (B,))
        check_operand(spec, in_arr, "inputs")
        bit_arr = bits.t().to(torch.uint8).contiguous()  # [nbits, B]
        out = torch.empty((12, B, spec.nl), dtype=LIMB_DTYPE, device=device)
        if B:
            regs = regfile(self.n_regs, spec, B, device)
            t = self._device_tables(device)
            lib = load_library(spec)
            with torch.cuda.device(device):
                err = lib.ripp_gtexp(
                    t["tab"].data_ptr(), self.table.shape[0],
                    t["consts"].data_ptr(), t["mask_regs"].data_ptr(),
                    len(self.sched.mask_inputs), bit_arr.data_ptr(), nbits,
                    in_arr.data_ptr(), out.data_ptr(), regs.data_ptr(),
                    B, block_threads(B),
                    torch.cuda.current_stream().cuda_stream)
            check_launch(err, "ripp_gtexp")
            FusedGtExp.launches += 1
        return list(out)


def fused_gtexp(ctx) -> FusedGtExp:
    key = ("gtexp", id(ctx))
    if key not in _FUSED:
        _FUSED[key] = FusedGtExp(ctx)
    return _FUSED[key]
