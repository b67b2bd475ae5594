"""The slice as a whole: the port's SIPP prove and verify against the JAX
package.

  * the port's prove at n = 8 on bls12_nano, SeededRng(17), reproduces
    tests/golden_transcripts.json["sipp"] byte for byte (sponge seed, every
    round's serialized (z_l, z_r), every challenge). That fixture is the
    JAX package's output; tests/test_golden.py re-derives it from ripp_tpu
    on every run;
  * ripp_tpu.models.sipp._instance_seed frames the same inputs into the
    same bytes;
  * the port's verify accepts the fixture's own GT elements (read back
    with deser_gt) and rejects a tampered proof and a wrong claimed value;
  * FrVec fold / hadamard and challenge_product_vec equal ripp_tpu's limb
    for limb (starting from the reference's limbs, carried over by
    convert.py), and PointVec fold / hadamard_scale / msm equal the host.

All comparisons are exact: tolerance zero.
"""

import json
import os

import numpy as np
import pytest

from ripp_tpu_torch.host import pairing as hp
from ripp_tpu_torch.models import sipp
from ripp_tpu_torch.models.vectors import FrVec, PointVec, challenge_product_vec
from ripp_tpu_torch.ops.points import dev_ctx
from ripp_tpu_torch.utils.convert import vec_from_reference, vec_to_reference
from ripp_tpu_torch.utils.fiat_shamir import (
    FiatShamirRng,
    SeededRng,
    rand_field,
    rand_sw_point,
)
from ripp_tpu_torch.utils.serialize import CurveSerializer


def _fixture():
    path = os.path.join(os.path.dirname(__file__), "golden_transcripts.json")
    with open(path) as fh:
        return json.load(fh)["sipp"]


@pytest.fixture(scope="module")
def instance():
    """The golden instance (n = 8, bls12_nano, SeededRng(17)), its claimed
    value and the port's proof of it."""
    ctx = dev_ctx("bls12_nano", device="cpu")
    host = ctx.host
    rng = SeededRng(17)
    n = 8
    A = [rand_sw_point(rng, host.g1) for _ in range(n)]
    B = [rand_sw_point(rng, host.g2) for _ in range(n)]
    r = [rand_field(rng, host.r) for _ in range(n)]
    value = sipp.product_of_pairings_with_coeffs(
        ctx, PointVec.from_host(ctx, "g1", A),
        PointVec.from_host(ctx, "g2", B), FrVec.from_ints(ctx, r))
    proof = sipp.prove(ctx, A, B, r, value)
    return ctx, A, B, r, value, proof


def test_golden_sipp_transcript(instance):
    ctx, A, B, r, value, proof = instance
    fix = _fixture()
    s = CurveSerializer(ctx.host)
    seed = sipp._instance_seed(ctx, A, B, r, value)
    assert seed.hex() == fix["seed"]
    fs = FiatShamirRng(seed)
    assert len(proof.gt_elems) == len(fix["rounds"]) == 3
    for (z_l, z_r), want in zip(proof.gt_elems, fix["rounds"]):
        blob = s.gt(z_l) + s.gt(z_r)
        assert blob.hex() == want["zlzr"]
        fs.absorb(blob)
        assert hex(fs.next_u128()) == want["x"]
    # the claimed value is the host's prod e(r_i A_i, B_i)
    want_value = hp.multi_pairing(
        ctx.host, [ctx.host.g1.scalar_mul(a, k) for a, k in zip(A, r)], B)
    assert value == want_value


def test_instance_seed_equals_reference(instance):
    from ripp_tpu.models import sipp as ref_sipp
    from ripp_tpu.ops.points import dev_ctx as ref_dev_ctx

    ctx, A, B, r, value, _ = instance
    assert ref_sipp._instance_seed(ref_dev_ctx("bls12_nano"), A, B, r,
                                   value) == sipp._instance_seed(
                                       ctx, A, B, r, value)


def test_verify_accepts_fixture_elements_and_rejects_tampered(instance):
    ctx, A, B, r, value, proof = instance
    s = CurveSerializer(ctx.host)
    size = s.gt_size()
    elems = []
    for rnd in _fixture()["rounds"]:
        blob = bytes.fromhex(rnd["zlzr"])
        elems.append((s.deser_gt(blob[:size]), s.deser_gt(blob[size:])))
    assert elems == proof.gt_elems
    assert sipp.verify(ctx, A, B, r, value, sipp.SIPPProof(elems))
    # one GT element changed (still in GT: squared)
    F12 = ctx.host.tower.fp12
    bad = list(elems)
    bad[1] = (bad[1][0], F12.mul(bad[1][1], bad[1][1]))
    assert not sipp.verify(ctx, A, B, r, value, sipp.SIPPProof(bad))


def test_verify_rejects_wrong_value(instance):
    ctx, A, B, r, value, proof = instance
    wrong = hp.gt_mul(ctx.host, value, value)
    assert not sipp.verify(ctx, A, B, r, wrong, proof)


def test_step_callback_runs_every_step_and_changes_nothing(instance):
    """prove / verify hand each step to `step(name, fn)` in order, and the
    proof and the verdict are the same as without it."""
    ctx, A, B, r, value, proof = instance
    seen = {"prove": [], "verify": []}

    def recorder(fn_name):
        def step(name, fn):
            seen[fn_name].append(name)
            return fn()
        return step

    got = sipp.prove(ctx, A, B, r, value, step=recorder("prove"))
    assert got.gt_elems == proof.gt_elems
    assert sipp.verify(ctx, A, B, r, value, got, step=recorder("verify"))
    assert seen["prove"] == (["instance_seed", "to_device", "rescale"]
                             + ["round_pairings", "fold_g1", "fold_g2"] * 3)
    assert seen["verify"] == [
        "instance_seed", "challenges", "gt_exp_batch", "gt_combine",
        "challenge_products", "to_device", "msm_g1", "msm_g2",
        "host_pairing"]


def _fr(ctx, n, seed):
    rng = SeededRng(seed)
    return [rand_field(rng, ctx.host.r) for _ in range(n)]


@pytest.mark.parametrize("op", ["fold", "hadamard", "challenges_msb",
                                "challenges_lsb"])
def test_frvec_ops_equal_reference(op):
    from ripp_tpu.models import vectors as ref_vectors
    from ripp_tpu.ops.points import dev_ctx as ref_dev_ctx

    rctx = ref_dev_ctx("bls12_nano")
    ctx = dev_ctx("bls12_nano", device="cpu")
    ra = ref_vectors.FrVec.from_ints(rctx, _fr(ctx, 8, 3))
    rb = ref_vectors.FrVec.from_ints(rctx, _fr(ctx, 8, 4))
    # the port starts from the reference's own limbs
    a, b = vec_from_reference(ctx, ra), vec_from_reference(ctx, rb)
    c = (1 << 20) + 17
    if op == "fold":
        want, got = ra.fold(rb, c), a.fold(b, c)
    elif op == "hadamard":
        want, got = ra.hadamard(rb), a.hadamard(b)
    else:
        xs = _fr(ctx, 3, 5)
        bit_of = ((lambda i, j: (i >> (2 - j)) & 1) if op.endswith("msb")
                  else (lambda i, j: (i >> j) & 1))
        want = ref_vectors.challenge_product_vec(rctx, xs, 8, bit_of)
        got = challenge_product_vec(ctx, xs, 8, bit_of)
    np.testing.assert_array_equal(np.asarray(want.arr), vec_to_reference(got))
    assert got.to_ints() == want.to_ints()


def test_pointvec_ops_equal_host():
    ctx = dev_ctx("bls12_nano", device="cpu")
    host = ctx.host
    A = [host.g1.scalar_mul(host.g1_gen, 3 * i + 1) for i in range(4)]
    B = [host.g2.scalar_mul(host.g2_gen, 5 * i + 2) for i in range(4)]
    ks = _fr(ctx, 4, 6)
    a, b = PointVec.from_host(ctx, "g1", A), PointVec.from_host(ctx, "g2", B)
    x = 12345
    folded = a.hi().fold(a.lo(), x).to_host()
    assert folded == [host.g1.add(host.g1.scalar_mul(p, x), q)
                      for p, q in zip(A[2:], A[:2])]
    assert b.hadamard_scale(FrVec.from_ints(ctx, ks)).to_host() == [
        host.g2.scalar_mul(q, k) for q, k in zip(B, ks)]
    assert a.msm(FrVec.from_ints(ctx, ks)) == host.g1.msm(A, ks)
    assert b.msm(FrVec.from_ints(ctx, ks)) == host.g2.msm(B, ks)
