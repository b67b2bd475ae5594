"""Batched optimal ate pairing on the GPU.

Design (the JAX package's):
  * PROJECTIVE (homogeneous) Miller loop, no inversions anywhere in the
    loop: line coefficients are denominator-scaled by Fp2 factors that the
    final exponentiation kills.
  * Per-pair Miller accumulators f_i (embarrassingly parallel); one
    log-depth Fp12 product tree at the end; one final exponentiation, on
    the device.
  * The BLS parameter's bit pattern is static: a loop over its bits with
    an addition step on the few set bits.
  * Lines are built sparsely in w-coefficients of Fp12 = Fp2[w]/(w^6 - xi)
    through the same twist embedding as the host model (host/pairing.py).

Identity-point pairs are masked to the generator during the loop and their
Miller value replaced by 1 afterwards.

Dispatch: on CUDA tensors `miller_batch` goes through the fused Miller
kernel (ops/pairing_fused.py) and every field product through the
Montgomery kernel (ops/fp_cuda.py); on CPU tensors, or in a plain context,
the plain versions run.

`gt_exp_batch` on the card is one launch of the fused GT-exponentiation
kernel (ops/pairing_fused.py FusedGtExp); elsewhere the plain square and
multiply over the tower.

Counterpart of ripp_tpu/ops/pairing.py. Not ported yet: the RNS branch of
miller_product. multi_pairing launches the whole batch at once (no chunk
tiers, see ops/curve.py), and gt_exp_batch launches the batch it is given
(the JAX package padded it to 64 to keep one XLA executable).
"""

from __future__ import annotations

import torch

from .points import DevCurveCtx
from .tower import (
    tree_bcast,
    tree_idx,
    tree_leaves,
    tree_map,
    tree_select,
    tree_stack,
)


class DevPairing:
    def __init__(self, ctx: DevCurveCtx):
        self.ctx = ctx
        host = ctx.host
        self.x_bits = tuple(int(b) for b in bin(abs(host.x))[3:])
        self.x_neg = host.x < 0
        self.twist = host.twist_type
        t = ctx.t
        self.fp, self.fp2, self.fp6, self.fp12 = t.fp, t.fp2, t.fp6, t.fp12
        self._fused = None
        self._gtexp_fused = None
        self._f12_kernels = None

    @property
    def fused(self):
        """Lazy one-launch fused Miller kernel (ops/pairing_fused.py);
        the trace/schedule cost is paid only when it is first used."""
        if self._fused is None:
            from .pairing_fused import fused_miller

            self._fused = fused_miller(self.ctx)
        return self._fused

    # ---- Fp12 products as one launch each -------------------------------------
    @staticmethod
    def _nest12(rows):
        # fp12 flat order: ((0,1),(2,3),(4,5)), ((6,7),(8,9),(10,11))
        return (
            ((rows[0], rows[1]), (rows[2], rows[3]), (rows[4], rows[5])),
            ((rows[6], rows[7]), (rows[8], rows[9]), (rows[10], rows[11])),
        )

    def _build_f12_kernels(self):
        """Fp12 mul and sqr traced into field programs (the host tower's
        Karatsuba formulas over the symbolic field) and wrapped as
        ProgramKernels: on the card one launch of the program executor
        computes a whole Fp12 product, where the stacked tower would make
        a Montgomery launch plus a few hundred add/sub launches. Results
        are canonical, so they equal the stacked tower's limb for limb."""
        from .kexec import ProgramKernel
        from .kprog import KProg, prog_tower, schedule

        def declare(prog):
            return self._nest12([prog.inp() for _ in range(12)])

        host = self.ctx.host
        mul = KProg("fp12_mul")
        _, _, _, F12, _ = prog_tower(mul, host)
        c = F12.mul(declare(mul), declare(mul))
        mul.out(tree_leaves(c))
        sqr = KProg("fp12_sqr")
        _, _, _, F12, _ = prog_tower(sqr, host)
        c = F12.sqr(declare(sqr))
        sqr.out(tree_leaves(c))
        return (ProgramKernel(self.fp, schedule(mul)),
                ProgramKernel(self.fp, schedule(sqr)))

    def _on_card(self, f) -> bool:
        return tree_leaves(f)[0].is_cuda and not self.ctx.plain

    def f12_mul(self, a, b):
        """Fp12 product: the program executor on the card, the stacked
        tower elsewhere."""
        if not self._on_card(a):
            return self.fp12.mul(a, b)
        if self._f12_kernels is None:
            self._f12_kernels = self._build_f12_kernels()
        return self._nest12(
            self._f12_kernels[0](tree_leaves(a) + tree_leaves(b)))

    def f12_sqr(self, a):
        if not self._on_card(a):
            return self.fp12.sqr(a)
        if self._f12_kernels is None:
            self._f12_kernels = self._build_f12_kernels()
        return self._nest12(self._f12_kernels[1](tree_leaves(a)))

    # ---- line coefficients ---------------------------------------------------
    def _line_coeffs_post_eval(self, cy_yP, cx_xP, c0):
        """The three nonzero w-slot coefficients of a line for _mul_by_line,
        from cy*yP and cx*xP (computed stacked with the step's other Fp2
        products in the Miller body) and c0:
        D-twist: (w^0, w^1, w^3) = (cy*yP, cx*xP, c0)
        M-twist: (w^0, w^3, w^5) = (xi*cy*yP, c0, cx*xP); the xi scale is
        killed by the final exponentiation."""
        if self.twist == "D":
            return (cy_yP, cx_xP, c0)
        return (self.ctx.t.mul_xi(cy_yP), c0, cx_xP)

    # ---- sparse line multiplication -----------------------------------------
    def _mul_by_line(self, f, coeffs):
        """f * line where the line occupies 3 of 6 w-slots.

        D-twist: slots (w^0, w^1, w^3) -> fp12 ((a0,0,0),(a1,a3,0)).
        M-twist: slots (w^0, w^3, w^5) -> fp12 ((a0,0,0),(0,a3,a5)).
        Karatsuba with the sparsity exploited: 13 (D) / 14 (M) fp2
        sub-products instead of the dense mul's 18, ALL stacked into one
        base-field mul call (same pattern as DevQuadExt.mul).
        """
        F2 = self.fp2
        t = self.ctx.t
        nr = t.mul_xi  # fp2 non-residue multiply (v^3 = xi)
        f0, f1 = f  # fp6 halves
        f00, f01, f02 = f0
        f10, f11, f12 = f1

        def stack_mul(pairs):
            ls, rs = zip(*[tree_bcast(a, b) for a, b in pairs])
            V = F2.mul(tree_stack(list(ls)), tree_stack(list(rs)))
            return [tree_idx(V, i) for i in range(len(pairs))]

        if self.twist == "D":
            a0, a1, a3 = coeffs  # A = (a0,0,0), B = (a1,a3,0)
            s01 = F2.add(f10, f11)
            b01 = F2.add(a1, a3)
            g0, g1, g2_ = F2.add(f00, f10), F2.add(f01, f11), F2.add(f02, f12)
            c01 = F2.add(a0, a1)
            sg01 = F2.add(g0, g1)
            prods = stack_mul([
                (f00, a0), (f01, a0), (f02, a0),          # v0 = f0*A
                (f10, a1), (f11, a3), (s01, b01), (f12, a3), (f12, a1),
                (g0, c01), (g1, a3), (sg01, F2.add(c01, a3)),
                (g2_, a3), (g2_, c01),
            ])
            (v00, v01, v02,
             m0, m1, tt, p4, p5,
             n0, n1, nt, n4, n5) = prods
            # v1 = f1*B with B=(b0,b1,0): c0 = m0 + nr(f12*b1), c1 =
            # (f10+f11)(b0+b1)-m0-m1, c2 = f12*b0 + m1
            v1 = (
                F2.add(m0, nr(p4)),
                F2.sub(F2.sub(tt, m0), m1),
                F2.add(p5, m1),
            )
            # w = (f0+f1)*(A+B), A+B = (c01, a3, 0): same shape
            w_ = (
                F2.add(n0, nr(n4)),
                F2.sub(F2.sub(nt, n0), n1),
                F2.add(n5, n1),
            )
            v0 = (v00, v01, v02)
        else:
            a0, a3, a5 = coeffs  # A = (a0,0,0), B = (0,b1,b2)=(0,a3,a5)
            s12 = F2.add(f11, f12)
            b12 = F2.add(a3, a5)
            g0, g1, g2_ = F2.add(f00, f10), F2.add(f01, f11), F2.add(f02, f12)
            prods = stack_mul([
                (f00, a0), (f01, a0), (f02, a0),          # v0 = f0*A
                (f11, a3), (f12, a5), (s12, b12), (f10, a3), (f10, a5),
                # w = (f0+f1) * (a0, a3, a5): dense CH-SQR3 6 products
                (g0, a0), (g1, a3), (g2_, a5),
                (F2.add(g0, g1), F2.add(a0, a3)),
                (F2.add(g0, g2_), F2.add(a0, a5)),
                (F2.add(g1, g2_), b12),
            ])
            (v00, v01, v02,
             m1, m2, tt, p1, p2,
             w0, w1, w2, t01, t02, t12) = prods
            # v1 = f1*(0,b1,b2): c0 = nr(f11 b2 + f12 b1), c1 = f10 b1 +
            # nr(f12 b2), c2 = f10 b2 + f11 b1
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

        F6 = self.fp6
        c0 = F6.add(v0, F6.mul_by_x(v1))     # v0 + nr6 * v1  (w^2 = v)
        c1 = F6.sub(F6.sub(w_, v0), v1)
        return (c0, c1)

    # ---- Miller loop ----------------------------------------------------------
    def _miller_impl(self, xP, yP, qx, qy):
        """Batched Miller f_{|x|,Q}(P). Inputs: xP,yP Fp limbs [n,NL];
        qx,qy Fp2 trees (twist affine). Returns Fp12 tree [n,...].

        INVERSION-FREE: T is kept in homogeneous projective twist
        coordinates; line coefficients are the denominator-scaled
        (2YZ^2, -3X^2 Z, 3X^3 - 2Y^2 Z) for doubling and
        (lambda, -theta, theta*qx - lambda*qy) with theta = Y - qy*Z,
        lambda = X - qx*Z for addition - the Fp2 scale factors vanish in
        the final exponentiation. This removes the per-iteration batched
        Fermat inversion of the affine formulation.

        This is the plain version of the fused Miller kernel
        (ops/pairing_fused.py): a Python loop over the bits of |x| with
        an addition step on the set bits."""
        F2, F12 = self.fp2, self.fp12
        g2curve = self.ctx.g2

        one2 = F2.one()
        q_proj_one = tree_map(
            lambda x: x.expand(qx[0].shape[:-1] + x.shape[-1:]), one2)

        b3 = g2curve.b3  # 3*b' device constant (twist curve coefficient)

        def stack2(pairs):
            """k independent Fp2 products in ONE stacked base-field mul
            (same pattern as _mul_by_line): each extra launch inside the
            loop costs more than the arithmetic it carries."""
            ls, rs = zip(*[tree_bcast(a, b) for a, b in pairs])
            V = F2.mul(tree_stack(list(ls)), tree_stack(list(rs)))
            return [tree_idx(V, i) for i in range(len(pairs))]

        def dbl(carry):
            """Combined doubling + line (Costello-Lange-Naehrig-style
            shared subexpressions, homogeneous a=0 twist; eprint 2010/526
            family).  Line coefficients (-H, 3X^2, E-B) equal the previous
            (2YZ^2, -3X^2 Z, 3X^3-2Y^2 Z) scaled by -1/Z (projective
            scale, killed by the final exponentiation; the equality uses
            the curve relation Y^2 Z = X^3 + b'Z^3).  The new point is the
            CLN double uniformly scaled by 4 (avoids the /2's).
            Non-complete formulas are sound here: T = [k]Q with
            0 < k < r never hits the identity.

            The Fp2 products run as THREE stacked mul calls (dependency
            levels), not ~10 individual ones."""
            (X, Y, Z), f = carry
            f = F12.sqr(f)
            # level 1: independent products of the current coordinates
            B, C, A, X2, YZ2, Zb = stack2([
                (Y, Y), (Z, Z), (X, Y), (X, X),
                (F2.add(Y, Z), F2.add(Y, Z)), (Z, b3),
            ])
            H = F2.sub(F2.sub(YZ2, B), C)            # 2YZ
            cy = F2.neg(H)
            cx = F2.mul_small(X2, 3)
            # level 2: E = 3 b' Z^2 (= Zb * Z) + the line evaluations at
            # the embedded G1 point (depend only on level 1)
            yP2 = (yP, torch.zeros_like(yP))
            xP2 = (xP, torch.zeros_like(xP))
            E, cy_yP, cx_xP = stack2([(Zb, Z), (cy, yP2), (cx, xP2)])
            F_ = F2.mul_small(E, 3)                  # 9 b' Z^2
            G = F2.add(B, F_)
            c0 = F2.sub(E, B)
            # level 3: everything needing E/G
            AX, GG, EE, BH = stack2([
                (A, F2.sub(B, F_)), (G, G), (E, E), (B, H),
            ])
            X3 = F2.mul_small(AX, 2)
            Y3 = F2.sub(GG, F2.mul_small(EE, 12))
            Z3 = F2.mul_small(BH, 4)
            f = self._mul_by_line(
                f, self._line_coeffs_post_eval(cy_yP, cx_xP, c0)
            )
            return ((X3, Y3, Z3), f)

        def addq(carry):
            (X, Y, Z), f = carry
            qyZ, qxZ = stack2([(qy, Z), (qx, Z)])
            theta = F2.sub(Y, qyZ)
            lam = F2.sub(X, qxZ)
            yP2 = (yP, torch.zeros_like(yP))
            xP2 = (xP, torch.zeros_like(xP))
            tqx, lqy, cy_yP, cx_xP = stack2([
                (theta, qx), (lam, qy),
                (lam, yP2), (F2.neg(theta), xP2),
            ])
            c0 = F2.sub(tqx, lqy)
            f = self._mul_by_line(
                f, self._line_coeffs_post_eval(cy_yP, cx_xP, c0)
            )
            T = g2curve.add((X, Y, Z), (qx, qy, q_proj_one))
            return (T, f)

        n_shape = xP.shape[:-1]
        f0 = self._ones_fp12(n_shape)
        carry = ((qx, qy, q_proj_one), f0)
        for bit in self.x_bits:
            carry = dbl(carry)
            if bit:
                carry = addq(carry)
        return carry[1]

    def _ones_fp12(self, batch_shape):
        one = self.fp.one()
        o = one.expand(tuple(batch_shape) + one.shape)
        z = torch.zeros_like(o)
        return ((o, z), (z, z), (z, z)), ((z, z), (z, z), (z, z))

    def _masked_inputs(self, g1_aff, g2_aff):
        """Mask degenerate (identity) pairs to the generator so the Miller
        loop stays regular; returns (xP, yP, qx, qy, skip)."""
        xP, yP, p_inf = g1_aff
        qx, qy, q_inf = g2_aff
        skip = p_inf | q_inf
        gen1 = self.ctx.g1_to_dev([self.ctx.host.g1_gen])
        gen2 = self.ctx.g2_to_dev([self.ctx.host.g2_gen])
        m = skip.unsqueeze(-1)
        xP = torch.where(m, gen1[0][0].expand(xP.shape), xP)
        yP = torch.where(m, gen1[1][0].expand(yP.shape), yP)
        qx = tree_select(
            skip, tree_map(lambda g: g[0].expand(xP.shape), gen2[0]), qx)
        qy = tree_select(
            skip, tree_map(lambda g: g[0].expand(xP.shape), gen2[1]), qy)
        return xP, yP, qx, qy, skip

    def miller_batch(self, g1_aff, g2_aff):
        """g1_aff: (x, y, inf) from DevSWCurve.normalize on G1;
        g2_aff: (x, y, inf) on G2. Returns per-pair Miller values [n], with
        identity pairs already set to 1 (conjugation for negative x applied
        after the final product)."""
        xP, yP, qx, qy, skip = self._masked_inputs(g1_aff, g2_aff)
        if xP.is_cuda and not self.ctx.plain:
            # one-launch register machine; bit-identical to the plain loop
            f = self.fused.miller(xP, yP, qx, qy)
        else:
            f = self._miller_impl(xP, yP, qx, qy)
        one = self._ones_fp12(xP.shape[:-1])
        return tree_select(skip, one, f)

    def miller_product(self, g1_aff, g2_aff):
        """Miller product of an affine pair batch -> [1, ...] fp12 limb
        tree (== product_reduce(miller_batch(...)))."""
        return self.product_reduce(self.miller_batch(g1_aff, g2_aff))

    def product_reduce(self, f):
        """Product of an Fp12 batch along axis 0 -> [1, ...] element (see
        ops/reduce.py)."""
        from .reduce import scan_reduce

        n = tree_leaves(f)[0].shape[0]
        red = scan_reduce(self.f12_mul, f, n)
        return tree_map(lambda x: x[None], red)

    # ---- final exponentiation (device) --------------------------------------
    @property
    def _frob2_consts(self):
        """Device fp2 constants g_k = xi^{k (p^2-1)/6}: the w^k-slot
        multipliers of the p^2-power Frobenius (which acts trivially on
        Fp2 itself since p^2 = 1 mod the quadratic structure)."""
        if getattr(self, "_frob2_cache", None) is None:
            host = self.ctx.host
            t = host.tower
            e = (host.p * host.p - 1) // 6
            fp = self.fp
            consts = []
            for k in range(6):
                c = t.fp2.pow(t.xi, k * e)
                consts.append((fp.const(c[0]), fp.const(c[1])))
            self._frob2_cache = consts
        return self._frob2_cache

    def _dev_frob2(self, f):
        """f^(p^2) on device: slot-wise fp2 constant multiplications."""
        F2 = self.fp2
        g = self._frob2_consts
        (s0, s2, s4), (s1, s3, s5) = f
        return (
            (s0, F2.mul(s2, g[2]), F2.mul(s4, g[4])),
            (F2.mul(s1, g[1]), F2.mul(s3, g[3]), F2.mul(s5, g[5])),
        )

    @property
    def _frob1_consts(self):
        """Device fp2 constants for the p-power Frobenius: slot k of the
        w-basis picks up xi^{k (p-1)/6} after the Fp2 conjugation (host
        tower frob12_c1/frob6 structure, flattened to the 6 w-slots)."""
        if getattr(self, "_frob1_cache", None) is None:
            host = self.ctx.host
            t = host.tower
            e = (host.p - 1) // 6
            fp = self.fp
            consts = []
            for k in range(6):
                c = t.fp2.pow(t.xi, k * e)
                consts.append((fp.const(c[0]), fp.const(c[1])))
            self._frob1_cache = consts
        return self._frob1_cache

    def _dev_frob1(self, f):
        """f^p on device: per-slot Fp2 conjugation (p = 3 mod 4 towers:
        u -> -u) then the slot constant multiplication."""
        F2 = self.fp2
        g = self._frob1_consts

        def cj(c):
            return (c[0], self.fp.neg(c[1]))

        (s0, s2, s4), (s1, s3, s5) = f
        return (
            (cj(s0), F2.mul(cj(s2), g[2]), F2.mul(cj(s4), g[4])),
            (F2.mul(cj(s1), g[1]), F2.mul(cj(s3), g[3]),
             F2.mul(cj(s5), g[5])),
        )

    def _cyc_conj(self, f):
        return (f[0], self.fp6.neg(f[1]))

    def _cyc_pow_const(self, g, e: int):
        """g^e for a static host integer e, g in the cyclotomic subgroup
        (inverse = conjugation).  MSB-first square and multiply with the
        full Fp12 squaring; e is static, so no select is needed."""
        if e == 0:
            return self._ones_fp12(tree_leaves(g)[0].shape[:1])
        neg = e < 0
        e = abs(e)
        acc = g
        for bit in bin(e)[3:]:
            acc = self.f12_sqr(acc)
            if bit == "1":
                acc = self.f12_mul(acc, g)
        return self._cyc_conj(acc) if neg else acc

    def _final_exp_impl(self, f):
        """f^((p^12-1)/r) on a [b, ...] fp12 batch.  Easy part via
        conj/inv/frob2; hard part via the exact BLS12 seed ladder
        h = ((x-1)/3)(x-1)(x+p)(x^2+p^2-1) + 1 (host/pairing.py
        hard_part_ladder, differentially tested against the blind
        exponentiation): 4 seed-length ladders instead of one ~4|p|-bit
        ladder (~5x fewer Fp12 ops)."""
        F12, F6 = self.fp12, self.fp6
        host = self.ctx.host
        mul = self.f12_mul
        g = mul((f[0], F6.neg(f[1])), F12.inv(f))       # f^(p^6-1)
        g = mul(self._dev_frob2(g), g)                  # ^(p^2+1)
        x = host.x
        g0 = self._cyc_pow_const(g, (x - 1) // 3)
        g1 = self._cyc_pow_const(g0, x - 1)
        g2 = mul(self._cyc_pow_const(g1, x), self._dev_frob1(g1))
        g3 = mul(
            mul(self._cyc_pow_const(self._cyc_pow_const(g2, x), x),
                self._dev_frob2(g2)),
            self._cyc_conj(g2),
        )
        return mul(g3, g)

    # ---- batched GT exponentiation ---------------------------------------------
    def gt_exp_batch(self, gs, es):
        """Batched GT exponentiation: host GT list [k], host int exponents
        [k] -> host GT list. MSB-first square and multiply over all
        r.bit_length() bits of every exponent (reduced mod r)."""
        host = self.ctx.host
        if len(gs) == 0:
            return []
        bits = self.ctx.scalars_to_bits([e % host.r for e in es],
                                        host.r.bit_length())
        f = self.ctx.t.fp12_to_dev(list(gs))
        return self.ctx.t.fp12_from_dev(self.gt_exp_tree(f, bits))

    def gt_exp_tree(self, f, bits):
        """f^e on an Fp12 tree of [k, NL] leaves, bits [k, nbits] (0/1,
        MSB first): one launch of the fused kernel on the card, the plain
        square and multiply elsewhere (bit-identical)."""
        from .tower import tree_select

        if self._on_card(f):
            if self._gtexp_fused is None:
                from .pairing_fused import fused_gtexp

                self._gtexp_fused = fused_gtexp(self.ctx)
            return self._gtexp_fused(f, bits)
        F12 = self.fp12
        out = self._ones_fp12((bits.shape[0],))
        for j in range(bits.shape[1]):
            sq = F12.sqr(out)
            wm = F12.mul(sq, f)
            out = tree_select(bits[:, j] > 0, wm, sq)
        return out

    def finalize_product(self, prod, conj_for_x: bool = True):
        """[1, ...] Miller-product tree -> host GT element, with the
        negative-x conjugation and the FULL final exponentiation on the
        device."""
        if self.x_neg and conj_for_x:
            prod = (prod[0], self.fp6.neg(prod[1]))
        out = self._final_exp_impl(prod)
        return self.ctx.t.fp12_from_dev(tree_map(lambda x: x[:1], out))[0]

    # ---- end-to-end -----------------------------------------------------------
    def multi_pairing(self, P_proj, Q_proj):
        """Full pairing product of projective device batches -> host GT
        element: normalize, Miller loop, product tree and final
        exponentiation all on the device, the whole batch at once."""
        g1a = self.ctx.g1.normalize(P_proj)
        g2a = self.ctx.g2.normalize(Q_proj)
        return self.finalize_product(self.miller_product(g1a, g2a))


_PAIRINGS = {}


def dev_pairing(ctx: DevCurveCtx) -> DevPairing:
    """Cached per context (a context is per curve, device and plain flag;
    the entry holds it, so its id cannot be reused)."""
    key = id(ctx)
    if key not in _PAIRINGS:
        _PAIRINGS[key] = DevPairing(ctx)
    return _PAIRINGS[key]
