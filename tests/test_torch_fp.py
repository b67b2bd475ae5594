"""ripp_tpu_torch.ops.fp.DevFp against the JAX package and Python bigints.

Same inputs (numpy from a seed) go through ripp_tpu.ops.fp.DevFp (its XLA
path, which is what runs on the CPU) and the port's DevFp on the CPU,
handed over by utils/convert.py. Every comparison is EXACT equality of
limbs or of host integers: this is integer arithmetic, the tolerance is
zero. BLS12-381 is compared with bigints only (no JAX compile at that
width).
"""

import random

import numpy as np
import pytest
import torch

from ripp_tpu.ops import fp as ref_fp
from ripp_tpu_torch.host.curves import get_curve
from ripp_tpu_torch.ops import fp as port_fp
from ripp_tpu_torch.utils.convert import from_reference, to_reference

OPS = ["add", "sub", "neg", "mul", "sqr", "mul_small", "inv"]
N = 37


def _operands(p, seed):
    rng = random.Random(seed)
    edge = [0, 1, p - 1]
    xs = [x for x in edge for _ in edge] + [rng.randrange(p) for _ in range(N)]
    ys = [y for _ in edge for y in edge] + [rng.randrange(p) for _ in range(N)]
    return xs, ys


def _apply(F, op, a, b):
    if op in ("add", "sub", "mul"):
        return getattr(F, op)(a, b)
    if op == "mul_small":
        return F.mul_small(a, 12)
    return getattr(F, op)(a)


def _expect(op, p, xs, ys):
    if op == "add":
        return [(x + y) % p for x, y in zip(xs, ys)]
    if op == "sub":
        return [(x - y) % p for x, y in zip(xs, ys)]
    if op == "mul":
        return [x * y % p for x, y in zip(xs, ys)]
    if op == "neg":
        return [(-x) % p for x in xs]
    if op == "sqr":
        return [x * x % p for x in xs]
    if op == "mul_small":
        return [12 * x % p for x in xs]
    return [pow(x, p - 2, p) for x in xs]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("curve_name", ["bls12_nano", "bls12_toy"])
def test_devfp_matches_reference(curve_name, op):
    import jax.numpy as jnp

    p = get_curve(curve_name).p
    spec_r = ref_fp.make_spec(curve_name + ".fp", p)
    spec_t = port_fp.make_spec(curve_name + ".fp", p)
    assert (spec_r.nl, spec_r.r, spec_r.n0inv) == (
        spec_t.nl, spec_t.r, spec_t.n0inv)
    xs, ys = _operands(p, 5)
    a_np = spec_r.to_mont_limbs(xs)
    b_np = spec_r.to_mont_limbs(ys)

    Fr = ref_fp.DevFp(spec_r)
    want = np.asarray(_apply(Fr, op, jnp.asarray(a_np), jnp.asarray(b_np)))

    Ft = port_fp.DevFp(spec_t, "cpu")
    got = _apply(Ft, op, from_reference(a_np, "cpu"),
                 from_reference(b_np, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_reference(got), want)  # tolerance 0
    assert spec_t.from_mont_limbs(got) == _expect(op, p, xs, ys)


@pytest.mark.parametrize("op", OPS)
def test_devfp_bls12_381_matches_bigints(op):
    p = get_curve("bls12_381").p
    spec = port_fp.make_spec("bls12_381.fp", p)
    assert spec.nl == 24
    xs, ys = _operands(p, 6)
    if op == "inv":  # a 381-bit Fermat ladder: keep the batch, it is one
        xs, ys = xs[:12], ys[:12]
    F = port_fp.DevFp(spec, "cpu")
    a = from_reference(spec.to_mont_limbs(xs), "cpu")
    b = from_reference(spec.to_mont_limbs(ys), "cpu")
    got = _apply(F, op, a, b)
    assert int(got.max()) < 1 << 16 and int(got.min()) >= 0
    assert spec.from_mont_limbs(got) == _expect(op, p, xs, ys)


def test_devfp_predicates_select_pow_and_broadcast():
    p = get_curve("bls12_toy").p
    spec = port_fp.make_spec("bls12_toy.fp", p)
    F = port_fp.DevFp(spec, "cpu")
    xs = [0, 5, p - 1, 5]
    a = from_reference(spec.to_mont_limbs(xs), "cpu")
    assert F.is_zero(a).tolist() == [True, False, False, False]
    assert F.eq(a, a[1]).tolist() == [False, True, False, True]
    m = torch.tensor([True, False, True, False])
    sel = F.select(m, a, F.one().expand(a.shape))
    assert spec.from_mont_limbs(sel) == [0, 1, p - 1, 1]
    assert spec.from_mont_limbs(F.pow(a, 5)) == [pow(x, 5, p) for x in xs]
    assert spec.from_mont_limbs(F.pow(a, 0)) == [1] * 4
    # an unbatched constant against a batch
    assert spec.from_mont_limbs(F.mul(a, F.const(7))) == [
        7 * x % p for x in xs]
    assert spec.from_mont_limbs(F.mul_int(a, 1 << 70)) == [
        (x << 70) % p for x in xs]
    assert spec.from_mont_limbs(F.mul_small(a, 0).contiguous()) == [0] * 4


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never give way to the plain version: a tensor
    that is not on the card is refused."""
    from ripp_tpu_torch.ops import fp_cuda

    spec = port_fp.make_spec("bls12_nano.fp", get_curve("bls12_nano").p)
    a = from_reference(spec.to_mont_limbs([3, 4]), "cpu")
    with pytest.raises(ValueError):
        fp_cuda.fp_mul(spec, a, a)
    with pytest.raises(ValueError):
        fp_cuda.fp_cheap(spec, "add", a, a)
    assert fp_cuda.launches == 0 and fp_cuda.cheap_launches == 0
