"""Device elliptic curve group law: branchless complete formulas.

Points are homogeneous projective (X:Y:Z) pytrees of limb tensors;
identity is (0:1:0). Addition/doubling use the Renes-Costello-Batina
complete formulas for a=0 short-Weierstrass curves (Algorithms 7 and 9 of
eprint 2015/1060): total, so no data-dependent branches.

Generic over a field-ops object (DevFp for G1, device Fp2 for G2) plus the
curve constant b3 = 3*b, so one class serves G1/G2 on every curve.

Scalar multiplication (`scalar_mul_bits`): on the card it is one launch
of the fused ladder kernel (ops/curve_fused.py, K4), with no switch: the
JAX package made its Pallas ladder opt-in because of minutes of Mosaic
compile, a cost nvcc does not have. The plain double-and-add loop
(`_scalar_mul_bits_impl`) runs on the CPU and in a plain context; the two
are bit-identical.

Counterpart of ripp_tpu/ops/curve.py. Not ported yet: DevEdwardsCurve.
Dropped: chunk_plan / CHUNK_TIERS / MIN_REDUCE_BATCH, which padded batches
to a few shapes so that XLA compiled few executables; nothing here
compiles per shape, so a batch is launched whole.
"""

from __future__ import annotations

import torch

from .tower import tree_bcast, tree_idx, tree_leaves, tree_map, tree_select, tree_stack


def pad_with_identity(curve: "DevSWCurve", pts, m: int):
    """Pad a projective point tree [n, ...] to [m, ...] with identity."""
    n = tree_leaves(pts)[0].shape[0]
    if m <= n:
        return pts
    tail_x = tree_map(
        lambda x: torch.zeros((m - n,) + x.shape[1:], dtype=x.dtype,
                              device=x.device), pts[0]
    )
    ident = curve.identity_like(tail_x)
    return tree_map(lambda a, b: torch.cat([a, b], dim=0), pts, ident)


class DevSWCurve:
    """a=0 short Weierstrass group law over field ops F."""

    def __init__(self, F, b3, name: str = "dev_curve"):
        self.F = F
        self.b3 = b3  # 3*b as a device field element
        self.name = name
        # set by DevCurveCtx (ops/points.py) on a context that launches
        # kernels: returns the group's FusedLadder
        self._fused_ladder_factory = None

    # --- identities ----------------------------------------------------------
    def identity_like(self, x):
        """Identity point (0:1:0) broadcast to the batch shape of limb
        tensor tree x (a field element tree)."""
        zero = tree_map(torch.zeros_like, x)
        one = self._bcast_like(self.F.one(), x)
        return (zero, one, tree_map(torch.zeros_like, x))

    @staticmethod
    def _bcast_const(c, like):
        # broadcast a constant element tree to the structure of `like`
        if isinstance(like, tuple):
            return tuple(DevSWCurve._bcast_const(ci, li) for ci, li in zip(c, like))
        return c

    def _bcast_like(self, c, like):
        return tree_map(
            lambda l, cc: cc.expand(l.shape), like,
            self._bcast_const(c, like),
        )

    def is_identity(self, P):
        leaves = tree_leaves(P[2])
        acc = (leaves[0] == 0).all(-1)
        for l in leaves[1:]:
            acc = acc & (l == 0).all(-1)
        return acc

    # --- complete group law (RCB15 algorithms 7 & 9, a = 0) ------------------
    def _stack_mul(self, pairs):
        """k independent base-field products in ONE stacked mul call (one
        launch of the Montgomery kernel for a dependency level)."""
        F = self.F
        ls, rs = zip(*[tree_bcast(a, b) for a, b in pairs])
        V = F.mul(tree_stack(list(ls)), tree_stack(list(rs)))
        return [tree_idx(V, i) for i in range(len(pairs))]

    def add(self, P, Q):
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        b3 = self.b3
        # level 1: the six cross products
        m_xx, m_yy, m_zz, m_xy, m_yz, m_xz = self._stack_mul([
            (X1, X2), (Y1, Y2), (Z1, Z2),
            (F.add(X1, Y1), F.add(X2, Y2)),
            (F.add(Y1, Z1), F.add(Y2, Z2)),
            (F.add(X1, Z1), F.add(X2, Z2)),
        ])
        t3 = F.sub(m_xy, F.add(m_xx, m_yy))      # X1Y2 + X2Y1
        t4 = F.sub(m_yz, F.add(m_yy, m_zz))      # Y1Z2 + Y2Z1
        ty = F.sub(m_xz, F.add(m_xx, m_zz))      # X1Z2 + X2Z1
        t0 = F.add(F.add(m_xx, m_xx), m_xx)      # 3 X1X2
        # level 2: the two b3 scalings
        t2, y3b = self._stack_mul([(b3, m_zz), (b3, ty)])
        z3s = F.add(m_yy, t2)
        t1s = F.sub(m_yy, t2)
        # level 3: the six output products
        p_a, p_b, p_c, p_d, p_e, p_f = self._stack_mul([
            (t4, y3b), (t3, t1s), (y3b, t0),
            (t1s, z3s), (t0, t3), (z3s, t4),
        ])
        return (F.sub(p_b, p_a), F.add(p_d, p_c), F.add(p_f, p_e))

    def double(self, P):
        F = self.F
        X, Y, Z = P
        b3 = self.b3
        t0, t1, t2m, txy = self._stack_mul([
            (Y, Y), (Y, Z), (Z, Z), (X, Y),
        ])
        z3a = F.add(t0, t0)
        z3a = F.add(z3a, z3a)
        z3a = F.add(z3a, z3a)                    # 8 Y^2
        t2 = F.mul(b3, t2m)
        y3a = F.add(t0, t2)
        t0b = F.sub(t0, F.add(F.add(t2, t2), t2))
        x3m, y3m, z3, x3b = self._stack_mul([
            (t2, z3a), (t0b, y3a), (t1, z3a), (t0b, txy),
        ])
        return (F.add(x3b, x3b), F.add(x3m, y3m), z3)

    def neg(self, P):
        X, Y, Z = P
        return (X, self.F.neg(Y), Z)

    def select(self, mask, P, Q):
        return tree_select(mask, P, Q)

    # --- scalar multiplication ------------------------------------------------
    def scalar_mul_bits(self, P, bits):
        """P * k where bits holds k's bits MSB first (0/1), shape [nbits]
        (a scalar shared by the batch) or [batch..., nbits] (one scalar an
        element). On CUDA tensors: one launch of the fused ladder kernel;
        elsewhere (or in a plain context) the plain loop below."""
        if (self._fused_ladder_factory is not None
                and tree_leaves(P)[0].is_cuda):
            return self._fused_ladder_factory().scalar_mul_bits(P, bits)
        return self._scalar_mul_bits_impl(P, bits)

    def _scalar_mul_bits_impl(self, P, bits):
        """Plain double-and-add, MSB first: double, add P, keep the sum
        where the bit is set (the add is complete, so no branches). The
        JAX package's lax.scan ladder, as a Python loop over the bits."""
        shared = bits.dim() == 1
        acc = self.identity_like(P[0])
        for i in range(bits.shape[-1]):
            acc = self.double(acc)
            added = self.add(acc, P)
            mask = (bits[i] if shared else bits[..., i]) > 0
            acc = self.select(mask, added, acc)
        return acc

    # --- normalization ---------------------------------------------------------
    def normalize(self, P):
        """(X:Y:Z) -> (x, y, is_inf): affine coordinates via field inversion.
        Identity lanes return x = y = 0 with is_inf = True."""
        F = self.F
        X, Y, Z = P
        inf = self.is_identity(P)
        safe_z = tree_select(inf, self._bcast_like(F.one(), Z), Z)
        zi = F.inv(safe_z)
        x = F.mul(X, zi)
        y = F.mul(Y, zi)
        zero = tree_map(torch.zeros_like, x)
        x = tree_select(inf, zero, x)
        y = tree_select(inf, zero, y)
        return (x, y, inf)

    def from_affine(self, x, y, inf):
        """(x, y, is_inf[batch]) -> projective with identity encoded (0:1:0)."""
        one = self._bcast_like(self.F.one(), x)
        zero = tree_map(torch.zeros_like, x)
        X = tree_select(inf, zero, x)
        Y = tree_select(inf, one, y)
        Z = tree_select(inf, zero, one)
        return (X, Y, Z)

    def eq(self, P, Q):
        """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1 (with both-
        identity handling)."""
        F = self.F
        x_eq = self._tree_feq(F.mul(P[0], Q[2]), F.mul(Q[0], P[2]))
        y_eq = self._tree_feq(F.mul(P[1], Q[2]), F.mul(Q[1], P[2]))
        p_inf, q_inf = self.is_identity(P), self.is_identity(Q)
        return ~(p_inf ^ q_inf) & ((p_inf & q_inf) | (x_eq & y_eq))

    # --- reductions -------------------------------------------------------------
    def sum_reduce(self, P):
        """Sum a batch of points along axis 0 to one point: log2(n)
        shift-and-add steps (ops/reduce.py scan_reduce, the JAX package's
        order of additions)."""
        from .reduce import scan_reduce

        return scan_reduce(self.add, P, tree_leaves(P)[0].shape[0])

    @staticmethod
    def _tree_feq(a, b):
        leaves_a, leaves_b = tree_leaves(a), tree_leaves(b)
        acc = (leaves_a[0] == leaves_b[0]).all(-1)
        for x, y in zip(leaves_a[1:], leaves_b[1:]):
            acc = acc & (x == y).all(-1)
        return acc
