"""The hybrid 8x16 Montgomery product (K1') of the port against the JAX
package.

  * the plain version (ripp_tpu_torch/ops/fp_cuda.mont_mul_limbs_hybrid8)
    against the JAX package's kernel body _mul_kernel_hybrid
    (ripp_tpu/ops/fp_pallas.py), called directly on numpy uint32 refs
    shaped [NL, 1, 1, B] (no pallas_call, no compile), against the CIOS
    plain version and against Python bigints: BLS12-381 Fp and Fr and the
    two toy curves' Fp and Fr, with the edge operands 0, 1, p-1, R mod p
    in every pairing;
  * the selection: a context made with fp_kernel="hybrid8" sends its Fp
    and Fr products to that version and gives the same values; contexts
    are cached per multiplier; an unknown multiplier raises; the kernel's
    wrapper refuses a CPU tensor (on the card it launches or raises).

Integer arithmetic: every comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from ripp_tpu_torch.host.curves import get_curve
from ripp_tpu_torch.ops import fp_cuda
from ripp_tpu_torch.ops.fp import DevFp, limbs_tensor, make_spec
from ripp_tpu_torch.ops.points import dev_ctx

FIELDS = [(c, f) for c in ("bls12_381", "bls12_nano", "bls12_toy")
          for f in ("fp", "fr")]


def _spec(curve_name, field):
    c = get_curve(curve_name)
    return make_spec(f"{curve_name}.{field}", c.p if field == "fp" else c.r)


def _operands(spec, seed, n_random=61):
    """Every pairing of the edge operands 0, 1, p-1, R mod p, then random
    pairs (numpy from a seed): two lists of canonical ints."""
    p = spec.p
    edge = [0, 1, p - 1, spec.r % p]
    xs = [x for x in edge for _ in edge]
    ys = [y for _ in edge for y in edge]
    rng = np.random.default_rng(seed)
    for _ in range(n_random):
        xs.append(int.from_bytes(rng.bytes(64), "little") % p)
        ys.append(int.from_bytes(rng.bytes(64), "little") % p)
    return xs, ys


def _reference_hybrid8(spec, a_limbs, b_limbs):
    """The JAX package's _mul_kernel_hybrid body on refs [NL, 1, 1, B]."""
    from ripp_tpu.ops.fp_pallas import _mul_kernel_hybrid

    kernel = _mul_kernel_hybrid(spec.nl, spec.p_limbs, spec.n0inv)
    a_ref = np.ascontiguousarray(a_limbs.T, dtype=np.uint32)[:, None, None, :]
    b_ref = np.ascontiguousarray(b_limbs.T, dtype=np.uint32)[:, None, None, :]
    o_ref = np.zeros_like(a_ref)
    kernel(a_ref, b_ref, o_ref)
    return o_ref[:, 0, 0, :].T


@pytest.mark.parametrize("curve_name,field", FIELDS)
def test_plain_hybrid8_equals_reference_body_cios_and_bigints(curve_name,
                                                              field):
    spec = _spec(curve_name, field)
    xs, ys = _operands(spec, seed=len(curve_name) * 7 + len(field))
    a_np, b_np = spec.to_mont_limbs(xs), spec.to_mont_limbs(ys)
    a, b = limbs_tensor(a_np, "cpu"), limbs_tensor(b_np, "cpu")
    got = fp_cuda.mont_mul_limbs_hybrid8(spec, a, b)
    assert got.dtype == torch.int32 and got.shape == a.shape
    want_ref = _reference_hybrid8(spec, a_np, b_np)
    assert np.array_equal(got.numpy().astype(np.uint32), want_ref)
    assert torch.equal(got, fp_cuda.mont_mul_limbs(spec, a, b))
    assert spec.from_mont_limbs(got) == [x * y % spec.p
                                         for x, y in zip(xs, ys)]


def test_plain_hybrid8_broadcasts_like_cios():
    spec = _spec("bls12_381", "fp")
    xs, ys = _operands(spec, seed=5, n_random=8)
    a = limbs_tensor(spec.to_mont_limbs(xs), "cpu").reshape(4, 6, spec.nl)
    b = limbs_tensor(spec.to_mont_limbs(ys[:6]), "cpu")
    assert torch.equal(fp_cuda.mont_mul_limbs_hybrid8(spec, a, b),
                       fp_cuda.mont_mul_limbs(spec, a, b))


@pytest.mark.parametrize("curve_name", ["bls12_nano", "bls12_381"])
def test_hybrid8_context_routes_fp_and_fr(curve_name, monkeypatch):
    ctx = dev_ctx(curve_name, device="cpu", fp_kernel="hybrid8")
    base = dev_ctx(curve_name, device="cpu")
    assert ctx is dev_ctx(curve_name, device="cpu", fp_kernel="hybrid8")
    assert ctx is not base and base.fp_kernel == "cios16"
    assert ctx.fp_kernel == ctx.t.fp.fp_kernel == ctx.t.fr.fp_kernel == \
        "hybrid8"
    calls = []
    real = fp_cuda.mont_mul_limbs_hybrid8

    def seen(spec, a, b):
        calls.append(spec.name)
        return real(spec, a, b)

    monkeypatch.setattr(fp_cuda, "mont_mul_limbs_hybrid8", seen)
    for fld, base_fld in ((ctx.t.fp, base.t.fp), (ctx.t.fr, base.t.fr)):
        xs, ys = _operands(fld.spec, seed=11, n_random=4)
        a = limbs_tensor(fld.spec.to_mont_limbs(xs), "cpu")
        b = limbs_tensor(fld.spec.to_mont_limbs(ys), "cpu")
        assert torch.equal(fld.mul(a, b), base_fld.mul(a, b))
    assert calls == [ctx.t.spec_fp.name, ctx.t.spec_fr.name]


def test_unknown_multiplier_raises_and_wrapper_refuses_cpu_tensors():
    spec = _spec("bls12_toy", "fp")
    with pytest.raises(ValueError):
        DevFp(spec, "cpu", fp_kernel="hybrid16")
    with pytest.raises(ValueError):
        dev_ctx("bls12_toy", device="cpu", fp_kernel="cios8")
    a = limbs_tensor(spec.to_mont_limbs([1, 2]), "cpu")
    before = fp_cuda.hybrid8_launches
    with pytest.raises(ValueError):
        fp_cuda.fp_mul_hybrid8(spec, a, a)
    assert fp_cuda.hybrid8_launches == before
