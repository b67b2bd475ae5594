"""ripp_tpu_torch.ops.tower (Fp2/Fp6/Fp12) against the JAX package's
tower on bls12_nano and against the host model on BLS12-381.

Same limbs go into both packages through utils/convert.py; outputs are
compared limb for limb. Integer arithmetic: the tolerance is zero.
"""

import random

import numpy as np
import pytest
import torch

from ripp_tpu.ops import tower as ref_tower
from ripp_tpu_torch.ops import tower as port_tower
from ripp_tpu_torch.utils.convert import from_reference, to_reference

FIELDS = ["fp2", "fp6", "fp12"]
OPS = ["mul", "sqr", "inv"]
DEG = {"fp2": 2, "fp6": 6, "fp12": 12}


def _rand_elems(host_F, deg, p, n, seed):
    rng = random.Random(seed)
    return [host_F.fromlist([rng.randrange(p) for _ in range(deg)])
            for _ in range(n)]


def _leaves(tree):
    return port_tower.tree_leaves(tree)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("field", FIELDS)
def test_tower_matches_reference_nano(field, op):
    import jax
    import jax.numpy as jnp

    tr = ref_tower.dev_tower("bls12_nano")
    tt = port_tower.dev_tower("bls12_nano", device="cpu")
    host_F = getattr(tr.curve.tower, field)
    xs = _rand_elems(host_F, DEG[field], tr.curve.p, 6, 11)
    ys = _rand_elems(host_F, DEG[field], tr.curve.p, 6, 12)
    a_ref = tr._to_dev(host_F, DEG[field], xs)
    b_ref = tr._to_dev(host_F, DEG[field], ys)
    a_np = jax.tree.map(np.asarray, a_ref)
    b_np = jax.tree.map(np.asarray, b_ref)

    Fr, Ft = getattr(tr, field), getattr(tt, field)
    a_t, b_t = from_reference(a_np, "cpu"), from_reference(b_np, "cpu")
    if op == "mul":
        want, got = Fr.mul(a_ref, b_ref), Ft.mul(a_t, b_t)
    else:
        want, got = getattr(Fr, op)(a_ref), getattr(Ft, op)(a_t)
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    got = [to_reference(g) for g in _leaves(got)]
    assert len(want) == len(got) == DEG[field]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)  # tolerance 0


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("field", FIELDS)
def test_tower_bls12_381_matches_host_model(field, op):
    tt = port_tower.dev_tower("bls12_381", device="cpu")
    host_F = getattr(tt.curve.tower, field)
    n = 3
    xs = _rand_elems(host_F, DEG[field], tt.curve.p, n, 21)
    ys = _rand_elems(host_F, DEG[field], tt.curve.p, n, 22)
    a = tt._to_dev(host_F, DEG[field], xs)
    b = tt._to_dev(host_F, DEG[field], ys)
    Ft = getattr(tt, field)
    if op == "mul":
        got = Ft.mul(a, b)
        want = [host_F.mul(x, y) for x, y in zip(xs, ys)]
    elif op == "sqr":
        got = Ft.sqr(a)
        want = [host_F.mul(x, x) for x in xs]
    else:
        got = Ft.inv(a)
        want = [host_F.inv(x) for x in xs]
    assert tt._from_dev(host_F, got) == want


def test_tree_helpers_and_conversions():
    tt = port_tower.dev_tower("bls12_toy", device="cpu")
    assert port_tower.dev_tower("bls12_toy", device="cpu") is tt
    assert port_tower.dev_tower("bls12_toy", device="cpu", plain=True) is not tt
    F2 = tt.curve.tower.fp2
    xs = _rand_elems(F2, 2, tt.curve.p, 4, 3)
    a = tt.fp2_to_dev(xs)
    assert tt.fp2_from_dev(a) == xs
    assert tt.fr_from_dev(tt.fr_to_dev([1, 2, 3])) == [1, 2, 3]
    stacked = port_tower.tree_stack([a, tt.fp2.one()])
    assert _leaves(stacked)[0].shape == (2, 4, tt.fp.nl)
    assert torch.equal(port_tower.tree_idx(stacked, 0)[1], a[1])
    m = torch.tensor([True, False, True, False])
    sel = port_tower.tree_select(m, a, port_tower.tree_map(
        torch.zeros_like, a))
    assert tt.fp2_from_dev(sel) == [xs[0], F2.zero(), xs[2], F2.zero()]
    assert tt.fp2.is_zero(sel).tolist() == [False, True, False, True]
    # the M-twist / generic non-residue branches build as well
    t377 = port_tower.dev_tower("bls12_377", device="cpu")
    F12 = t377.curve.tower.fp12
    x = _rand_elems(F12, 12, t377.curve.p, 1, 4)
    y = _rand_elems(F12, 12, t377.curve.p, 1, 5)
    got = t377.fp12.mul(t377.fp12_to_dev(x), t377.fp12_to_dev(y))
    assert t377.fp12_from_dev(got) == [F12.mul(x[0], y[0])]


def test_no_card_means_dev_tower_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        port_tower.dev_tower("bls12_nano")
