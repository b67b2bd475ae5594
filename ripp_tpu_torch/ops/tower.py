"""Device extension towers: Fp2/Fp6/Fp12 on limb tensors.

Elements are pytrees (nested tuples) of int32 limb tensors, mirroring the
host representation exactly. As in the JAX package the device tower uses
STACKED multiplication: every Karatsuba sub-product of an extension mul
is gathered into one batched base-field mul call, so a full Fp12 mul is a
single DevFp.mul (one launch of the Montgomery kernel on the card) on a
[3,6,3]-stacked tensor instead of 54 separate ones.

The non-residue multiplications are specialized per curve (e.g. BLS12-381:
beta = -1 so u-mult is a negation; xi = 1+u so xi-mult is one add/sub pair).

A pytree here is nested tuples of tensors; tree_map / tree_leaves below
are the small stand-ins for jax.tree.

Counterpart of ripp_tpu/ops/tower.py.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from ..host.curves import (
    PairingCurve,
    bls12_377,
    bls12_381,
    bls12_nano,
    bls12_toy,
)
from .fp import DevFp, limbs_tensor, make_spec


def tree_map(fn, tree, *rest):
    """Apply fn leafwise over same-structure nested tuples of tensors."""
    if isinstance(tree, tuple):
        return tuple(
            tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, tuple):
        out = []
        for t in tree:
            out.extend(tree_leaves(t))
        return out
    return [tree]


def tree_select(mask, a, b):
    """Select between two equal-structure limb pytrees with a batch-shaped
    boolean mask (broadcast over the limb axis)."""
    return tree_map(
        lambda x, y: torch.where(mask.unsqueeze(-1), x, y), a, b
    )


def tree_stack(elems):
    """Stack K same-structure elements along a new leading axis, first
    broadcasting each leaf position to its common shape."""
    def stack(*arrs):
        shape = torch.broadcast_shapes(*(a.shape for a in arrs))
        return torch.stack([a.expand(shape) for a in arrs])

    return tree_map(stack, elems[0], *elems[1:])


def tree_idx(tree, i):
    return tree_map(lambda x: x[i], tree)


def tree_bcast(a, b):
    """Broadcast two same-structure trees leafwise to their common shapes
    (numpy trailing-dim alignment breaks when one operand is an unbatched
    constant and the other carries stack/batch axes)."""
    sa = tree_map(lambda x, y: x.expand(torch.broadcast_shapes(x.shape, y.shape)), a, b)
    sb = tree_map(lambda x, y: y.expand(torch.broadcast_shapes(x.shape, y.shape)), a, b)
    return sa, sb


class DevQuadExt:
    """Quadratic extension over a device base field with stacked muls."""

    def __init__(self, base, mul_by_nr: Callable, name: str):
        self.base = base
        self.mul_by_nr = mul_by_nr
        self.name = name
        self.p = base.p
        self.degree = 2 * base.degree

    def zero(self):
        return (self.base.zero(), self.base.zero())

    def one(self):
        return (self.base.one(), self.base.zero())

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def mul(self, a, b):
        # Karatsuba with the three sub-products in ONE stacked base mul.
        # Broadcast operands to common shapes BEFORE stacking: trailing-dim
        # alignment handles (batch, NL) vs (NL), but not once the leading
        # stack axis is added.
        a, b = tree_bcast(a, b)
        B = self.base
        L = tree_stack([a[0], a[1], B.add(a[0], a[1])])
        R = tree_stack([b[0], b[1], B.add(b[0], b[1])])
        V = B.mul(L, R)
        v0, v1, m = tree_idx(V, 0), tree_idx(V, 1), tree_idx(V, 2)
        c0 = B.add(v0, self.mul_by_nr(v1))
        c1 = B.sub(B.sub(m, v0), v1)
        return (c0, c1)

    def sqr(self, a):
        # complex squaring, two sub-products in one stacked base mul
        B = self.base
        L = tree_stack([a[0], B.add(a[0], a[1])])
        R = tree_stack([a[1], B.add(a[0], self.mul_by_nr(a[1]))])
        V = B.mul(L, R)
        v0, t = tree_idx(V, 0), tree_idx(V, 1)
        c0 = B.sub(B.sub(t, v0), self.mul_by_nr(v0))
        c1 = B.add(v0, v0)
        return (c0, c1)

    def inv(self, a):
        B = self.base
        norm = B.sub(B.sqr(a[0]), self.mul_by_nr(B.sqr(a[1])))
        ninv = B.inv(norm)
        return (B.mul(a[0], ninv), B.neg(B.mul(a[1], ninv)))

    def conj(self, a):
        return (a[0], self.base.neg(a[1]))

    def scale(self, a, s):
        return (self.base.mul(a[0], s), self.base.mul(a[1], s))

    def mul_small(self, a, k: int):
        return (self.base.mul_small(a[0], k), self.base.mul_small(a[1], k))

    def mul_int(self, a, n: int):
        return (self.base.mul_int(a[0], n), self.base.mul_int(a[1], n))

    def is_zero(self, a):
        return self.base.is_zero(a[0]) & self.base.is_zero(a[1])


class DevCubicExt:
    """Cubic extension over a device base field with stacked muls."""

    def __init__(self, base, mul_by_nr: Callable, name: str):
        self.base = base
        self.mul_by_nr = mul_by_nr
        self.name = name
        self.p = base.p
        self.degree = 3 * base.degree

    def zero(self):
        z = self.base.zero()
        return (z, z, z)

    def one(self):
        return (self.base.one(), self.base.zero(), self.base.zero())

    def add(self, a, b):
        B = self.base
        return (B.add(a[0], b[0]), B.add(a[1], b[1]), B.add(a[2], b[2]))

    def sub(self, a, b):
        B = self.base
        return (B.sub(a[0], b[0]), B.sub(a[1], b[1]), B.sub(a[2], b[2]))

    def neg(self, a):
        B = self.base
        return (B.neg(a[0]), B.neg(a[1]), B.neg(a[2]))

    def mul(self, a, b):
        # CH-SQR3 layout, six sub-products in one stacked base mul
        a, b = tree_bcast(a, b)
        B = self.base
        L = tree_stack([a[0], a[1], a[2], B.add(a[0], a[1]),
                        B.add(a[0], a[2]), B.add(a[1], a[2])])
        R = tree_stack([b[0], b[1], b[2], B.add(b[0], b[1]),
                        B.add(b[0], b[2]), B.add(b[1], b[2])])
        V = B.mul(L, R)
        v0, v1, v2 = tree_idx(V, 0), tree_idx(V, 1), tree_idx(V, 2)
        t01, t02, t12 = tree_idx(V, 3), tree_idx(V, 4), tree_idx(V, 5)
        c0 = B.add(v0, self.mul_by_nr(B.sub(B.sub(t12, v1), v2)))
        c1 = B.add(B.sub(B.sub(t01, v0), v1), self.mul_by_nr(v2))
        c2 = B.add(B.sub(B.sub(t02, v0), v2), v1)
        return (c0, c1, c2)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        B = self.base
        a0, a1, a2 = a
        t0 = B.sub(B.sqr(a0), self.mul_by_nr(B.mul(a1, a2)))
        t1 = B.sub(self.mul_by_nr(B.sqr(a2)), B.mul(a0, a1))
        t2 = B.sub(B.sqr(a1), B.mul(a0, a2))
        norm = B.add(
            B.mul(a0, t0),
            self.mul_by_nr(B.add(B.mul(a2, t1), B.mul(a1, t2))),
        )
        ninv = B.inv(norm)
        return (B.mul(t0, ninv), B.mul(t1, ninv), B.mul(t2, ninv))

    def scale(self, a, s):
        B = self.base
        return (B.mul(a[0], s), B.mul(a[1], s), B.mul(a[2], s))

    def mul_by_x(self, a):
        """Multiply by the extension generator v (v^3 = nr)."""
        return (self.mul_by_nr(a[2]), a[0], a[1])

    def is_zero(self, a):
        B = self.base
        return B.is_zero(a[0]) & B.is_zero(a[1]) & B.is_zero(a[2])


class DevTower:
    """Bundles DevFp + device fp2/fp6/fp12 ops for one pairing curve."""

    def __init__(self, curve: PairingCurve, device, plain: bool = False,
                 fp_kernel: str = "cios16"):
        self.curve = curve
        self.device = torch.device(device)
        self.plain = plain
        self.fp_kernel = fp_kernel
        self.spec_fp = make_spec(curve.name + ".fp", curve.p)
        self.spec_fr = make_spec(curve.name + ".fr", curve.r)
        self.fp = DevFp(self.spec_fp, self.device, plain=plain,
                        fp_kernel=fp_kernel)
        self.fr = DevFp(self.spec_fr, self.device, plain=plain,
                        fp_kernel=fp_kernel)

        p = curve.p
        beta = curve.tower.beta  # u^2 = beta
        fp = self.fp

        # --- u-multiplication (Fp2 non-residue) -----------------------------
        if beta == p - 1:
            mul_beta = fp.neg
        else:
            k = (p - beta) % p
            if k < 16:  # beta = -k for small k
                mul_beta = lambda a: fp.neg(fp.mul_small(a, k))
            else:
                beta_c = fp.const(beta)
                mul_beta = lambda a: fp.mul(a, beta_c)
        self.fp2 = DevQuadExt(fp, mul_beta, name=curve.name + ".dev.fp2")

        # --- xi-multiplication (Fp6/Fp12 non-residue, xi in Fp2) ------------
        xi = curve.tower.xi
        fp2 = self.fp2
        if xi == (1, 1):
            # (a0 + a1 u)(1 + u) = (a0 + beta*a1) + (a0 + a1) u
            def mul_xi(a):
                return (fp.add(a[0], mul_beta(a[1])), fp.add(a[0], a[1]))
        elif xi == (0, 1):
            # (a0 + a1 u) * u = beta*a1 + a0 u
            def mul_xi(a):
                return (mul_beta(a[1]), a[0])
        else:
            xi_c = (fp.const(xi[0]), fp.const(xi[1]))

            def mul_xi(a):
                return fp2.mul(a, xi_c)

        self.mul_xi = mul_xi
        self.fp6 = DevCubicExt(fp2, mul_xi, name=curve.name + ".dev.fp6")
        self.fp12 = DevQuadExt(
            self.fp6, self.fp6.mul_by_x, name=curve.name + ".dev.fp12"
        )

    # --- host <-> device conversion (single elements and vectors) -----------
    def _to_dev(self, F_host, F_flat_deg, vals):
        """vals: list of host tower elements for a field of degree d ->
        pytree of [n, NL] tensors."""
        spec = self.spec_fp
        flat = [F_host.tolist(v) for v in vals]  # [n][d] ints
        d = F_flat_deg
        arrs = []
        for i in range(d):
            arrs.append(limbs_tensor(
                spec.to_mont_limbs([row[i] for row in flat]), self.device))
        return self._nest(arrs, d)

    @staticmethod
    def _nest(arrs, d):
        if d == 1:
            return arrs[0]
        if d == 2:
            return (DevTower._nest(arrs[: d // 2], d // 2),
                    DevTower._nest(arrs[d // 2 :], d // 2))
        if d == 12:
            # fp12 = (fp6, fp6); fp6 = (fp2, fp2, fp2)
            return (DevTower._nest(arrs[:6], 6), DevTower._nest(arrs[6:], 6))
        if d == 6:
            return (DevTower._nest(arrs[0:2], 2), DevTower._nest(arrs[2:4], 2),
                    DevTower._nest(arrs[4:6], 2))
        raise ValueError(d)

    @staticmethod
    def _flatten(tree):
        if isinstance(tree, tuple):
            out = []
            for t in tree:
                out.extend(DevTower._flatten(t))
            return out
        return [tree]

    def fp_to_dev(self, vals):
        return self._to_dev(self.curve.tower.fp, 1, vals)

    def fp2_to_dev(self, vals):
        return self._to_dev(self.curve.tower.fp2, 2, vals)

    def fp12_to_dev(self, vals):
        return self._to_dev(self.curve.tower.fp12, 12, vals)

    def fr_to_dev(self, ints):
        return limbs_tensor(self.spec_fr.to_mont_limbs(list(ints)), self.device)

    def _from_dev(self, F_host, tree):
        arrs = self._flatten(tree)
        cols = [self.spec_fp.from_mont_limbs(a) for a in arrs]
        n = len(cols[0])
        return [F_host.fromlist([c[i] for c in cols]) for i in range(n)]

    def fp_from_dev(self, tree):
        return self.spec_fp.from_mont_limbs(tree)

    def fp2_from_dev(self, tree):
        return self._from_dev(self.curve.tower.fp2, tree)

    def fp12_from_dev(self, tree):
        return self._from_dev(self.curve.tower.fp12, tree)

    def fr_from_dev(self, arr):
        return self.spec_fr.from_mont_limbs(arr)


_CURVES = {
    "bls12_381": bls12_381,
    "bls12_377": bls12_377,
    "bls12_toy": bls12_toy,
    "bls12_nano": bls12_nano,
}


@functools.lru_cache(maxsize=None)
def _dev_tower(curve_name: str, device: torch.device, plain: bool,
               fp_kernel: str) -> DevTower:
    if curve_name not in _CURVES:
        raise ValueError(curve_name)
    return DevTower(_CURVES[curve_name](), device, plain=plain,
                    fp_kernel=fp_kernel)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another; raises when the card is asked for and there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "versions on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but none is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def dev_tower(curve_name: str, device=None, plain: bool = False,
              fp_kernel: str = "cios16") -> DevTower:
    """Cached tower for (curve, device, plain, fp_kernel). plain=True
    gives a tower whose field ops always take their plain PyTorch
    versions; fp_kernel picks the Montgomery multiplier (ops/fp.py)."""
    return _dev_tower(curve_name, resolve_device(device), bool(plain),
                      fp_kernel)
