"""Device-backed protocol vectors (Fr scalars, G1/G2 points, placeholders).

These are the protocol layer's working objects: big vectors stay resident
on the device as limb trees; the log-round SIPP folds, hadamard rescales
and MSMs run there; only single elements cross to the host (for
Fiat-Shamir).

Fold conventions follow gipa.rs:261-291: `fold(self, other, c)` computes
c * self + other, with the scalar bit-width chosen from c (the reference's
128-bit-challenge optimization falls out automatically).

Counterpart of ripp_tpu/models/vectors.py. Every op runs on the whole
vector in one call: the JAX package's chunk tiers, padding and per-chunk
MSMs combined on the host kept its XLA executables few, which nothing
here needs. Not ported yet (the TIPP argument does not reach them):
FrVec.lo / hi / scale / first / inner_product, PointVec.scale / sum.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops import msm as msm_mod
from ..ops.points import DevCurveCtx
from ..ops.tower import tree_map


def _nbits_for(ctx: DevCurveCtx, c: int) -> int:
    rbits = ctx.host.r.bit_length()
    return min(128, rbits) if c < (1 << 128) else rbits


def challenge_product_vec(ctx: DevCurveCtx, xs: Sequence[int], n: int,
                          bit_of=lambda i, j: (i >> j) & 1) -> "FrVec":
    """FrVec of w_i = prod_j xs[j]^{bit_of(i, j)} for i in 0..n-1.

    Default bit order: xs[j] contributes when bit j (LSB-first) of the
    index is set -- GIPA's final-ck expansion with the reversed transcript.
    SIPP passes bit_of=lambda i, j: (i >> (L-1-j)) & 1 (MSB-first).
    L batch-n products (replaces the reference's O(n log n) host
    expansions, gipa.rs:373-381 and sipp/src/lib.rs:163-171)."""
    L = len(xs)
    mask = np.zeros((n, L), dtype=bool)
    for j in range(L):
        for i in range(n):
            mask[i, j] = bool(bit_of(i, j))
    fr = ctx.t.fr
    xs_dev = ctx.t.fr_to_dev([x % ctx.host.r for x in xs])
    mask = torch.from_numpy(mask).to(ctx.device)
    one = fr.one()
    acc = one.expand((n,) + one.shape)
    for j in range(L):
        sel = torch.where(mask[:, j:j + 1], xs_dev[j][None, :], one[None, :])
        acc = fr.mul(acc, sel)
    return FrVec(ctx, acc, n)


class FrVec:
    """Vector of Fr scalars: Montgomery limbs [n, NL] on the device."""

    def __init__(self, ctx: DevCurveCtx, arr, n: int):
        self.ctx = ctx
        self.arr = arr
        self.n = n

    @classmethod
    def from_ints(cls, ctx: DevCurveCtx, ints: Sequence[int]) -> "FrVec":
        return cls(ctx, ctx.t.fr_to_dev([i % ctx.host.r for i in ints]),
                   len(ints))

    def to_ints(self) -> List[int]:
        return self.ctx.t.fr_from_dev(self.arr)

    def fold(self, other: "FrVec", c: int) -> "FrVec":
        """c * self + other (elementwise)."""
        fr = self.ctx.t.fr
        cc = fr.const(c % self.ctx.host.r)
        return FrVec(self.ctx, fr.add(fr.mul(self.arr, cc), other.arr),
                     self.n)

    def hadamard(self, other: "FrVec") -> "FrVec":
        fr = self.ctx.t.fr
        return FrVec(self.ctx, fr.mul(self.arr, other.arr), self.n)


class PointVec:
    """Vector of curve points (projective limb tree) on the device."""

    def __init__(self, ctx: DevCurveCtx, grp: str, pts, n: int):
        self.ctx = ctx
        self.grp = grp  # 'g1' | 'g2'
        self.pts = pts
        self.n = n

    @property
    def dcurve(self):
        return self.ctx.g1 if self.grp == "g1" else self.ctx.g2

    @classmethod
    def from_host(cls, ctx: DevCurveCtx, grp: str, points: Sequence):
        to_dev = ctx.g1_to_dev if grp == "g1" else ctx.g2_to_dev
        return cls(ctx, grp, to_dev(list(points)), len(points))

    def to_host(self) -> List:
        return self._to_host(self.pts)

    def __len__(self):
        return self.n

    def _slice(self, sl) -> "PointVec":
        pts = tree_map(lambda x: x[sl], self.pts)
        n = len(range(*sl.indices(self.n)))
        return PointVec(self.ctx, self.grp, pts, n)

    def lo(self) -> "PointVec":
        return self._slice(slice(0, self.n // 2))

    def hi(self) -> "PointVec":
        return self._slice(slice(self.n // 2, self.n))

    def fold(self, other: "PointVec", c: int) -> "PointVec":
        """c * self + other (elementwise, shared scalar)."""
        bits = self.ctx.scalar_bits(c % self.ctx.host.r,
                                    _nbits_for(self.ctx, c))
        cv = self.dcurve
        out = cv.add(cv.scalar_mul_bits(self.pts, bits), other.pts)
        return PointVec(self.ctx, self.grp, out, self.n)

    def hadamard_scale(self, scalars: FrVec) -> "PointVec":
        """Per-element rescale: out_i = scalars_i * self_i (e.g. A o r)."""
        bits = self.ctx.fr_limbs_to_bits(scalars.arr)
        return PointVec(self.ctx, self.grp,
                        self.dcurve.scalar_mul_bits(self.pts, bits), self.n)

    def pair_product(self, other: "PointVec"):
        """prod_i e(self_i, other_i) -> host GT; self in G1, other in G2
        (PairingIP / AFGHO commit kernel, inner_products/src/lib.rs:51-74):
        one multi_pairing of the whole vector."""
        from ..ops.pairing import dev_pairing

        if (self.grp, other.grp) != ("g1", "g2"):
            raise ValueError(f"pair_product of {self.grp} with {other.grp}")
        return dev_pairing(self.ctx).multi_pairing(self.pts, other.pts)

    def first(self):
        """The first element as a host point."""
        return self._to_host(tree_map(lambda x: x[:1], self.pts))[0]

    def msm(self, scalars: FrVec):
        """MSM against an Fr vector -> host point (MIPP kernel,
        inner_products/src/lib.rs:118-142 analog)."""
        res = msm_mod.msm(self.dcurve, self.ctx.t.fr, self.pts, scalars.arr)
        return self._to_host(tree_map(lambda x: x[None], res))[0]

    def _to_host(self, pts) -> List:
        from_dev = (self.ctx.g1_from_dev if self.grp == "g1"
                    else self.ctx.g2_from_dev)
        return from_dev(pts)


class PlaceholderVec:
    """Vector of HomomorphicPlaceholderValue keys (no data): the identity
    commitment's keys. TIPP never splits or folds it; the SSM
    configurations, which do, come with their slice."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n
