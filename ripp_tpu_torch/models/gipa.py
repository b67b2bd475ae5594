"""GIPA: the generalized inner product argument (log-round recursive fold).

Re-implementation of arkworks ripp ip_proofs/src/gipa.rs as a host-driven
loop over device kernels: per round, six bulk reductions (two commitments
+ one inner product per side, each a batched pairing product for TIPP) and
four vector folds, then one Fiat-Shamir hash on the host.

Exact reference semantics preserved:
  * asymmetric split (gipa.rs:207-217): m_a_1 = m_a[n/2:] pairs with
    ck_a_1 = ck_a[:n/2]; m_b/ck_b mirrored
  * challenge swap (gipa.rs:248-256): the hashed 128-bit value plays c_inv
    (lands on the G2/key side); its inverse is the transcript challenge c
  * transcript/steps stored REVERSED (final round first), gipa.rs:298-299
  * verifier: com <- c*com_1 + com + c_inv*com_2 per round; final
    commitment keys via the challenge-product expansion, contracted with a
    device MSM

On the card each round's six pairing products run the fused Miller kernel
(K3), the program executor (K2) and the Montgomery kernel (K1, or K1' in a
hybrid8 context); the four folds are launches of the fused ladder (K4: G1
folds by the full-width c, G2 folds by the 128-bit c_inv); the verifier's
GT exponentiations are one launch of the fused GT-exponentiation kernel
(K5).

Counterpart of ripp_tpu/models/gipa.py: the same code over the port's
modules, transcripts byte-identical. `prove_with_aux` also takes an
optional `step(name, fn)` that runs each of its steps (`fn()`) and returns
the result (models/sipp.py's idiom); chip_smoke.py passes a timer. The
verifier is the batched one (models/pairing_check.py), the reference's
default; its RIPP_BATCH_VERIFY=0 per-equation shape is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Sequence, Tuple

from ..errors import InnerProductArgumentError, check_power_of_two
from ..host import pairing as hp
from ..ops.pairing import dev_pairing
from ..utils.fiat_shamir import blake2b_digest
from ..utils.serialize import nonce_bytes
from .algebra import HostAlg, IdentityOutput
from .vectors import PointVec, challenge_product_vec


def _run(name: str, fn: Callable):
    """The default `step`: run the step, nothing else."""
    return fn()


@dataclass
class GIPAConfig:
    """One point of the instantiation matrix (models/instances.py)."""

    name: str
    ctx: Any
    ip: Any    # .compute(m_a, m_b) -> host element, .out_kind
    lmc: Any   # left-message commitment
    rmc: Any   # right-message commitment
    ipc: Any   # inner-product commitment (IdentityCommitment in the matrix)

    def ip_single(self, a, b):
        """The inner product of two single host elements (the pairing
        inner product's; the other kinds wait for their configs)."""
        if self.ip.out_kind != "gt":
            raise ValueError(f"ip_single of kind {self.ip.out_kind}")
        return hp.pairing(self.ctx.host, a, b)


@dataclass
class GIPAProof:
    # steps stored reversed (final round first), matching the reference
    steps: List[Tuple[Tuple, Tuple]]  # ((com_a,com_b,com_t), (com_a,com_b,com_t))
    r_base: Tuple[Any, Any]           # (m_a base, m_b base) host elements


@dataclass
class GIPAAux:
    transcript: List[int]             # challenges, reversed (final round first)
    ck_base: Tuple[Any, Any]


def _ser_com(cfg: GIPAConfig, com) -> bytes:
    a, b, t = com
    return (cfg.lmc.out_alg.ser(a) + cfg.rmc.out_alg.ser(b)
            + cfg.ipc.out_alg.ser(t))


def round_challenge(cfg: GIPAConfig, prev_c: int, com_1, com_2
                    ) -> Tuple[int, int]:
    """Returns (c, c_inv) with c = inverse(hash128), c_inv = hash128
    (the reference's swap, gipa.rs:248-256): hash128 is the first 16
    bytes, big-endian, of Blake2b(nonce || prev_c || com_1 || com_2),
    with the counter nonce retried while it is 0 mod r."""
    r = cfg.ctx.host.r
    base = _ser_com(cfg, com_1) + _ser_com(cfg, com_2)
    prev = HostAlg(cfg.ctx.host, "fr").ser(prev_c)
    counter = 0
    while True:
        digest = blake2b_digest(nonce_bytes(counter) + prev + base)
        h = int.from_bytes(digest[:16], "big") % r
        if h != 0:
            return pow(h, -1, r), h
        counter += 1


def prove_with_aux(cfg: GIPAConfig, m_a, m_b, ck_a, ck_b, ck_t,
                   step: Callable = _run) -> Tuple[GIPAProof, GIPAAux]:
    n = len(m_a)
    if not (n == len(m_b) == len(ck_a) == len(ck_b)):
        raise InnerProductArgumentError.message_length_invalid(
            len(m_a), len(m_b)
        )
    check_power_of_two(n)
    steps = []
    transcript: List[int] = []
    prev_c = 0
    while n > 1:
        # asymmetric split (gipa.rs:207-217)
        m_a_1, m_a_2 = m_a.hi(), m_a.lo()
        ck_a_1, ck_a_2 = ck_a.lo(), ck_a.hi()
        m_b_1, m_b_2 = m_b.lo(), m_b.hi()
        ck_b_1, ck_b_2 = ck_b.hi(), ck_b.lo()

        def commit():  # gipa.rs:219-232
            com_1 = (
                cfg.lmc.commit(ck_a_1, m_a_1),
                cfg.rmc.commit(ck_b_1, m_b_1),
                cfg.ipc.commit(ck_t, [cfg.ip.compute(m_a_1, m_b_1)]),
            )
            com_2 = (
                cfg.lmc.commit(ck_a_2, m_a_2),
                cfg.rmc.commit(ck_b_2, m_b_2),
                cfg.ipc.commit(ck_t, [cfg.ip.compute(m_a_2, m_b_2)]),
            )
            return com_1, com_2

        com_1, com_2 = step("commitments", commit)
        c, c_inv = step("challenge", lambda: round_challenge(
            cfg, prev_c, com_1, com_2))
        m_a, m_b, ck_a, ck_b = step("folds", lambda: (  # gipa.rs:261-291
            m_a_1.fold(m_a_2, c),
            m_b_2.fold(m_b_1, c_inv),
            ck_a_2.fold(ck_a_1, c_inv),
            ck_b_1.fold(ck_b_2, c),
        ))

        steps.append((com_1, com_2))
        transcript.append(c)
        prev_c = c
        n //= 2

    proof = GIPAProof(steps=list(reversed(steps)),
                      r_base=(m_a.first(), m_b.first()))
    aux = GIPAAux(transcript=list(reversed(transcript)),
                  ck_base=(ck_a.first(), ck_b.first()))
    return proof, aux


def prove(cfg: GIPAConfig, values, ck, com) -> GIPAProof:
    """Full prove with the reference's consistency prechecks (gipa.rs:108)."""
    m_a, m_b, t = values
    ck_a, ck_b, ck_t = ck
    com_a, com_b, com_t = com
    if not cfg.ipc.out_alg.eq(
        cfg.ipc.commit(ck_t, [cfg.ip.compute(m_a, m_b)]), com_t
    ):
        raise InnerProductArgumentError.inner_product_invalid()
    check_power_of_two(len(m_a))
    if not cfg.lmc.out_alg.eq(cfg.lmc.commit(ck_a, m_a), com_a):
        raise InnerProductArgumentError("left message commitment mismatch")
    if not cfg.rmc.out_alg.eq(cfg.rmc.commit(ck_b, m_b), com_b):
        raise InnerProductArgumentError("right message commitment mismatch")
    proof, _ = prove_with_aux(cfg, m_a, m_b, ck_a, ck_b, ck_t)
    return proof


def _gt_kind(alg):
    if isinstance(alg, HostAlg) and alg.kind == "gt":
        return "raw"
    if getattr(alg, "kind", None) == "identity" and alg.inner.kind == "gt":
        return "identity"
    return None


def compute_recursive_challenges(cfg: GIPAConfig, com, proof: GIPAProof
                                 ) -> Tuple[Tuple, List[int]]:
    """Replay Fiat-Shamir and fold the commitments (gipa.rs:322-363).
    Returns (base_com, transcript) with transcript reversed like the
    reference (final round first). The fold is an abelian sum, so every
    GT-kind slot's terms (all three of TIPP's) go through ONE batched GT
    exponentiation (one launch of K5 on the card)."""
    transcript: List[int] = []
    prev_c = 0
    for com_1, com_2 in reversed(proof.steps):  # prove order
        c, _ = round_challenge(cfg, prev_c, com_1, com_2)
        transcript.append(c)
        prev_c = c
    r = cfg.ctx.host.r
    c_invs = [pow(c, -1, r) for c in transcript]

    algs = (cfg.lmc.out_alg, cfg.rmc.out_alg, cfg.ipc.out_alg)
    slot_items = []
    for slot, alg in enumerate(algs):
        elems, exps = [], []
        for (com_1, com_2), c, ci in zip(reversed(proof.steps),
                                         transcript, c_invs):
            elems += [com_1[slot], com_2[slot]]
            exps += [c, ci]
        slot_items.append((alg, elems, exps))

    batch_plan = []
    all_elems, all_exps = [], []
    for si, (alg, elems, exps) in enumerate(slot_items):
        k = _gt_kind(alg)
        if k == "raw":
            batch_plan.append((si, k, len(all_elems), len(elems)))
            all_elems += elems
            all_exps += exps
        elif k == "identity" and all(len(e.items) == 1 for e in elems):
            batch_plan.append((si, k, len(all_elems), len(elems)))
            all_elems += [e.items[0] for e in elems]
            all_exps += exps
    parts_all = dev_pairing(cfg.ctx).gt_exp_batch(all_elems, all_exps)

    folded = [None] * len(slot_items)
    for si, k, off, cnt in batch_plan:
        alg, _, _ = slot_items[si]
        acc = com[si]
        for p in parts_all[off:off + cnt]:
            acc = alg.add(acc, IdentityOutput([p], "gt")
                          if k == "identity" else p)
        folded[si] = acc
    if any(f is None for f in folded):
        raise ValueError(f"{cfg.name}: only GT-kind commitments fold here "
                         "(the other kinds come with their configs)")
    return tuple(folded), list(reversed(transcript))


def final_ck_exponents(r: int, transcript_reversed: Sequence[int]
                       ) -> Tuple[List[int], List[int]]:
    """Challenge-product expansion (gipa.rs:373-381): with the reversed
    transcript, w_a[idx] = prod_{i: bit_i(idx)} c_i^{-1} and w_b uses c_i."""
    w_a = [1]
    w_b = [1]
    for i, c in enumerate(transcript_reversed):
        c_inv = pow(c, -1, r)
        for j in range(1 << i):
            w_a.append(w_a[j] * c_inv % r)
            w_b.append(w_b[j] * c % r)
    return w_a, w_b


def compute_final_commitment_keys(cfg: GIPAConfig, ck_a, ck_b,
                                  transcript: Sequence[int]):
    """Verifier-side folded keys, via a device MSM against the
    challenge-product vector (L batch-n Fr products; the reference folds
    serially, gipa.rs:383-397)."""
    r = cfg.ctx.host.r
    n = len(ck_a)
    c_invs = [pow(c, -1, r) for c in transcript]

    def contract(ck: PointVec, xs):
        return ck.msm(challenge_product_vec(cfg.ctx, xs, n))

    return contract(ck_a, c_invs), contract(ck_b, list(transcript))


def verify_base_commitment(cfg: GIPAConfig, base_ck, base_com,
                           proof: GIPAProof, rand=None) -> bool:
    """The three base-commitment checks: pairing-shaped ones fold into one
    device Miller product + final exponentiation
    (models/pairing_check.py), the others run directly."""
    from .pairing_check import PairingCheck, add_base_commitment_checks

    a_base, b_base = proof.r_base
    pc = PairingCheck(cfg.ctx, rand=rand)
    direct = add_base_commitment_checks(
        pc, cfg, base_ck, base_com, a_base, b_base)
    return direct is None and pc.verify()


def verify(cfg: GIPAConfig, ck, com, proof: GIPAProof, rand=None) -> bool:
    """`rand` is the PairingCheck's source of random coefficients (see
    there); the default draws them from os.urandom."""
    ck_a, ck_b, ck_t = ck
    n = len(ck_a)
    if n != len(ck_b):
        raise InnerProductArgumentError.message_length_invalid(n, len(ck_b))
    check_power_of_two(n)
    base_com, transcript = compute_recursive_challenges(cfg, com, proof)
    ck_a_base, ck_b_base = compute_final_commitment_keys(
        cfg, ck_a, ck_b, transcript
    )
    return verify_base_commitment(
        cfg, (ck_a_base, ck_b_base, ck_t), base_com, proof, rand=rand
    )
