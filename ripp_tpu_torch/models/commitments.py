"""Doubly homomorphic commitments and inner products (device-backed), the
part the TIPP instantiation uses.

  AFGHO16 (G1/G2 flavors)  - pairing-product commitment to group vectors
  Identity                 - pass-through (message in the clear)
plus the pairing inner product. Bulk commits run on the device (one
multi_pairing of the whole vector: the fused Miller kernel, the program
executor and the Montgomery kernel on the card). The AFGHO commitments'
single-element `commit_single` / `verify_single` (the reference's
per-equation base checks) wait for the RIPP_BATCH_VERIFY=0 verifier:
the batched verifier adds those equations to a PairingCheck.

Counterpart of ripp_tpu/models/commitments.py. Not ported yet (MIPP and
the scalar and SSM instantiations): MultiexpIP, ScalarIP,
PedersenCommitment, SSMPlaceholderCommitment.
"""

from __future__ import annotations

from typing import Sequence

from ..errors import check_same_length
from ..ops.points import DevCurveCtx
from ..utils.fiat_shamir import random_generators
from .algebra import HostAlg, IdentityAlg, IdentityOutput
from .vectors import PlaceholderVec, PointVec


class PairingIP:
    """prod_i e(A_i, B_i) (the TIPP inner product)."""

    out_kind = "gt"

    def __init__(self, ctx: DevCurveCtx):
        self.ctx = ctx

    def compute(self, a: PointVec, b: PointVec):
        check_same_length(a, b)
        return a.pair_product(b)


class AFGHOCommitmentG1:
    """com = prod_i e(M_i, K_i), M in G1, K in G2, output GT
    (dh_commitments/src/afgho16/mod.rs:20-34 capability)."""

    name = "afgho_g1"
    msg_kind = "g1"
    key_kind = "g2"

    def __init__(self, ctx: DevCurveCtx):
        self.ctx = ctx
        self.out_alg = HostAlg(ctx.host, "gt")

    def setup(self, rng, size: int) -> PointVec:
        return PointVec.from_host(
            self.ctx, "g2", random_generators(rng, self.ctx.host.g2, size)
        )

    def commit(self, keys: PointVec, msgs: PointVec):
        check_same_length(keys, msgs)
        return msgs.pair_product(keys)


class AFGHOCommitmentG2:
    """com = prod_i e(K_i, M_i), M in G2, K in G1, output GT."""

    name = "afgho_g2"
    msg_kind = "g2"
    key_kind = "g1"

    def __init__(self, ctx: DevCurveCtx):
        self.ctx = ctx
        self.out_alg = HostAlg(ctx.host, "gt")

    def setup(self, rng, size: int) -> PointVec:
        return PointVec.from_host(
            self.ctx, "g1", random_generators(rng, self.ctx.host.g1, size)
        )

    def commit(self, keys: PointVec, msgs: PointVec):
        check_same_length(keys, msgs)
        return keys.pair_product(msgs)


class IdentityCommitment:
    """Pass-through commitment: output = message vector in the clear."""

    msg_kind = None  # any host element kind
    key_kind = "placeholder"

    def __init__(self, ctx: DevCurveCtx, inner_kind: str):
        self.ctx = ctx
        self.inner_kind = inner_kind
        self.name = f"identity_{inner_kind}"
        self.out_alg = IdentityAlg(HostAlg(ctx.host, inner_kind))

    def setup(self, rng, size: int):
        return PlaceholderVec(size)

    def commit(self, keys, msgs: Sequence) -> IdentityOutput:
        return IdentityOutput(list(msgs), self.inner_kind)

    def commit_single(self, key, msg) -> IdentityOutput:
        return IdentityOutput([msg], self.inner_kind)

    def verify_single(self, key, msg, com) -> bool:
        return self.out_alg.eq(self.commit_single(key, msg), com)
