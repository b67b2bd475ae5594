"""The port's own copies of the transcript utilities against the JAX
package's: ChaCha20 word streams, the Fiat-Shamir sponge, the seeded
sampling of fields and points, and the canonical serialization. All pure
Python on both sides; every comparison is of bytes or integers (exact).
"""

import pytest

from ripp_tpu.host.curves import get_curve as ref_get_curve
from ripp_tpu.utils import chacha as ref_chacha
from ripp_tpu.utils import fiat_shamir as ref_fs
from ripp_tpu.utils.serialize import CurveSerializer as RefSerializer
from ripp_tpu_torch.host.curves import get_curve
from ripp_tpu_torch.utils import chacha, fiat_shamir
from ripp_tpu_torch.utils.serialize import CurveSerializer


def _draws(rng):
    return ([rng.next_u32() for _ in range(20)]
            + [rng.next_u64() for _ in range(9)]
            + [rng.next_u128() for _ in range(5)]
            + [rng.fill_bytes(37)])


@pytest.mark.parametrize("seed", [bytes(32), bytes(range(32)),
                                  b"\xff" * 31 + b"\x01"])
def test_chacha_stream_equals_reference(seed):
    assert _draws(chacha.ChaChaRng(seed)) == _draws(
        ref_chacha.ChaChaRng(seed))


def test_fiat_shamir_sponge_equals_reference():
    got = fiat_shamir.FiatShamirRng(b"instance")
    want = ref_fs.FiatShamirRng(b"instance")
    assert got.seed == want.seed
    for k in range(4):
        blob = bytes([k]) * (17 + 40 * k)
        got.absorb(blob)
        want.absorb(blob)
        assert got.seed == want.seed
        assert _draws(got) == _draws(want)


@pytest.mark.parametrize("curve_name", ["bls12_nano", "bls12_toy"])
def test_seeded_sampling_equals_reference(curve_name):
    c, rc = get_curve(curve_name), ref_get_curve(curve_name)
    got, want = fiat_shamir.SeededRng(17), ref_fs.SeededRng(17)
    for _ in range(3):
        assert fiat_shamir.rand_field(got, c.r) == ref_fs.rand_field(
            want, rc.r)
        assert fiat_shamir.rand_sw_point(got, c.g1) == ref_fs.rand_sw_point(
            want, rc.g1)
        assert fiat_shamir.rand_sw_point(got, c.g2) == ref_fs.rand_sw_point(
            want, rc.g2)


@pytest.mark.parametrize("curve_name", ["bls12_nano", "bls12_381"])
def test_serializer_bytes_equal_reference(curve_name):
    from ripp_tpu_torch.host import pairing as hp

    c, rc = get_curve(curve_name), ref_get_curve(curve_name)
    s, rs = CurveSerializer(c), RefSerializer(rc)
    A = [c.g1.scalar_mul(c.g1_gen, 3 + k) for k in range(3)] + [None]
    B = [c.g2.scalar_mul(c.g2_gen, 5 + k) for k in range(3)] + [None]
    frs = [0, 1, c.r - 1, 12345]
    assert s.g1_vec(A) == rs.g1_vec(A)
    assert s.g2_vec(B) == rs.g2_vec(B)
    assert s.fr_vec(frs) == rs.fr_vec(frs)
    for pt in A:
        assert s.g1(pt, compressed=True) == rs.g1(pt, compressed=True)
    for pt in B:
        assert s.g2(pt, compressed=True) == rs.g2(pt, compressed=True)
    if curve_name == "bls12_nano":  # a host pairing at 381 bits is slow
        gt = hp.pairing(c, A[0], B[1])
        assert s.gt(gt) == rs.gt(gt)
        assert s.deser_g1(s.g1(A[1])) == A[1]
        assert s.deser_g2(s.g2(B[2])) == B[2]


def test_deser_gt_round_trip_and_subgroup_check():
    from ripp_tpu_torch.host import pairing as hp

    c = get_curve("bls12_nano")
    s, rs = CurveSerializer(c), RefSerializer(ref_get_curve("bls12_nano"))
    gt = hp.pairing(c, c.g1_gen, c.g2.scalar_mul(c.g2_gen, 7))
    assert s.deser_gt(s.gt(gt)) == gt == rs.deser_gt(s.gt(gt))
    # an Fp12 element outside the order-r subgroup is refused
    F12 = c.tower.fp12
    off = F12.mul(gt, F12.fromlist([2] + [0] * 11))
    with pytest.raises(ValueError):
        s.deser_gt(s.gt(off))
