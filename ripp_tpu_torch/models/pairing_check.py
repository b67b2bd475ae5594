"""Deferred batched verification of pairing equations.

The reference verifier checks each pairing equation with its own host
pairing (the two KZG commitment-key openings, tipa/mod.rs:340-368, and the
base-commitment checks, gipa.rs:406-414). Here every equation

    prod_j e(P_ij, Q_ij) == T_i

is accumulated and checked as ONE batched device Miller product + ONE
final exponentiation, under independent random 128-bit coefficients rho_i
(the standard random-linear-combination batching argument):

    prod_i prod_j e(rho_i * P_ij, Q_ij) == prod_i T_i^{rho_i}.

If any single equation fails, the combined check fails except with
probability ~2^-128 over the verifier's coefficients. The left side is one
`DevPairing.multi_pairing`; the right side one `gt_exp_batch` (one launch
of the fused GT-exponentiation kernel on the card) and a few host Fp12
products. The G1-side rho scaling runs on the host (128-bit scalars, the
native group law).

Counterpart of ripp_tpu/models/pairing_check.py, with the same decisions:
in particular `verify()` accepts when no pairs were added, whatever
right-hand sides were (the reference's rule, pairing_check.py:72; test
tests/test_torch_tipa.py pins it). The coefficients come from `rand`: a
callable that returns an int, or a seeded torch.Generator; without one
they come from os.urandom, as in the reference.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch


def _rho_source(rand):
    if rand is None:
        return lambda: int.from_bytes(os.urandom(16), "little") | 1
    if isinstance(rand, torch.Generator):
        def draw():
            words = torch.randint(0, 1 << 16, (8,), generator=rand,
                                  dtype=torch.int64).tolist()
            return sum(w << (16 * i) for i, w in enumerate(words)) | 1
        return draw
    return rand


class PairingCheck:
    """Accumulator for pairing product equations, verified in one batch."""

    def __init__(self, ctx, rand=None):
        self.ctx = ctx
        host = ctx.host
        self._one = host.tower.fp12.one()
        self._ps: List = []   # host G1 points (already rho-scaled)
        self._qs: List = []   # host G2 points
        self._rhs: List = []  # host GT elements
        self._exps: List[int] = []
        self._first = True
        self._rand = _rho_source(rand)

    def add(self, pairs: Sequence[Tuple], rhs=None) -> None:
        """Require prod e(P, Q) over `pairs` == rhs (None/one() => 1).

        The first equation keeps coefficient 1 (its rho cancels), every
        later one gets an independent random 128-bit rho.
        """
        host = self.ctx.host
        rho = 1 if self._first else self._rand()
        self._first = False
        for P, Q in pairs:
            self._ps.append(P if rho == 1 else host.g1.scalar_mul(P, rho))
            self._qs.append(Q)
        if rhs is not None and rhs != self._one:
            self._rhs.append(rhs)
            self._exps.append(rho)

    def verify(self) -> bool:
        """One device Miller product + final exponentiation against the
        batched right-hand side."""
        if not self._ps:
            return True
        from ..ops.pairing import dev_pairing

        ctx = self.ctx
        f12 = ctx.host.tower.fp12
        dp = dev_pairing(ctx)
        lhs = dp.multi_pairing(
            ctx.g1_to_dev(self._ps), ctx.g2_to_dev(self._qs)
        )
        rhs = self._one
        for t in dp.gt_exp_batch(self._rhs, self._exps):
            rhs = f12.mul(rhs, t)
        return lhs == rhs


def add_base_commitment_checks(pc: PairingCheck, cfg, base_ck, base_com,
                               a_base, b_base) -> Optional[bool]:
    """Accumulate the three base-commitment checks (gipa.rs:406-414) into
    `pc` where they are pairing equations; run the rest directly.

    Returns None when everything was batched or directly verified true;
    False as soon as a direct (non-batchable) check fails.
    """
    from .algebra import PLACEHOLDER, IdentityOutput
    from .commitments import (
        AFGHOCommitmentG1,
        AFGHOCommitmentG2,
        IdentityCommitment,
        PairingIP,
    )

    ck_a, ck_b, ck_t = base_ck
    com_a, com_b, com_t = base_com

    for mc, key, msg, com in (
        (cfg.lmc, ck_a, a_base, com_a),
        (cfg.rmc, ck_b, b_base, com_b),
    ):
        if isinstance(mc, AFGHOCommitmentG1):
            pc.add([(msg, key)], rhs=com)
        elif isinstance(mc, AFGHOCommitmentG2):
            pc.add([(key, msg)], rhs=com)
        elif not mc.verify_single(key, msg, com):
            return False

    # t = <a, b>: for the pairing IP with the identity commitment the
    # equation e(a_base, b_base) == com_t joins the batch (this otherwise
    # costs one host pairing via ip_single + one GT equality).
    if (isinstance(cfg.ip, PairingIP)
            and isinstance(cfg.ipc, IdentityCommitment)
            and cfg.ipc.inner_kind == "gt"
            and isinstance(com_t, IdentityOutput)
            and len(com_t.items) == 1):
        pc.add([(a_base, b_base)], rhs=com_t.items[0])
    else:
        t_base = cfg.ip_single(a_base, b_base)
        if not cfg.ipc.verify_single(PLACEHOLDER, t_base, com_t):
            return False
    return None
