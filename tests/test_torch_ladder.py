"""The scalar ladder (K4's slice) against the JAX package:

  * `_build_point_progs` gives the reference's schedules (segments,
    register numbers, constants) for g1 and g2, and the BLS12-381 counts;
  * the port's plain ladder (shared and per-element bits, g1 and g2)
    equals ripp_tpu's DevSWCurve._scalar_mul_bits_impl limb for limb on
    bls12_nano, from the same limbs handed over by convert.py;
  * the fused ladder's tables, replayed with the plain executor, equal
    the plain ladder and the host (bls12_nano), and on CPU tensors
    scalar_mul_bits launches nothing;
  * fr_limbs_to_bits and sum_reduce against the reference and the host.

All comparisons are exact: tolerance zero.
"""

import numpy as np
import pytest
import torch

from ripp_tpu.host.curves import get_curve as ref_get_curve
from ripp_tpu.ops.curve_fused import _build_point_progs as ref_point_progs
from ripp_tpu_torch.host.curves import get_curve
from ripp_tpu_torch.ops.curve_fused import FusedLadder, _build_point_progs
from ripp_tpu_torch.ops.points import dev_ctx
from ripp_tpu_torch.ops.tower import tree_leaves
from ripp_tpu_torch.utils.convert import from_reference, to_reference

# (double, add) programs on BLS12-381: products, registers
BLS12_381_COUNTS = {
    "g1": ((9, 15), (14, 19)),
    "g2": ((27, 39), (42, 58)),
}


def _segments_plain(sched):
    out = []
    for kind, items in sched.segments:
        if kind == "muls":
            out.append((kind, [tuple(t) for t in items]))
        else:
            out.append((kind, [(o.kind, o.dst, o.a, o.b, o.m) for o in items]))
    return out


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("curve_name", ["bls12_toy", "bls12_381"])
def test_point_progs_equal_reference(curve_name, group):
    got = _build_point_progs(get_curve(curve_name), group)
    want = ref_point_progs(ref_get_curve(curve_name), group)
    for g, w in zip(got, want):
        assert g.name == w.name
        assert g.n_regs == w.n_regs
        assert g.inputs == w.inputs
        assert g.mask_inputs == w.mask_inputs == []
        assert g.outputs == w.outputs
        assert g.consts == w.consts
        assert _segments_plain(g) == _segments_plain(w)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_prog_counts_bls12_381(group):
    progs = _build_point_progs(get_curve("bls12_381"), group)
    for sched, (muls, n_regs) in zip(progs, BLS12_381_COUNTS[group]):
        assert sum(sched.mul_groups()) == muls
        assert sched.n_regs == n_regs


def _points(ctx, group, n):
    host = ctx.host
    if group == "g1":
        pts = [host.g1.scalar_mul(host.g1_gen, 3 * i + 2) for i in range(n)]
        return ctx.g1, ctx.g1_to_dev(pts)
    pts = [host.g2.scalar_mul(host.g2_gen, 5 * i + 2) for i in range(n)]
    return ctx.g2, ctx.g2_to_dev(pts)


def _bits_matrix(n, nbits, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(n, nbits), dtype=np.uint8)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_ladder_equals_reference(group, shared):
    import jax
    import jax.numpy as jnp

    from ripp_tpu.ops.points import dev_ctx as ref_dev_ctx

    rctx = ref_dev_ctx("bls12_nano")
    ctx = dev_ctx("bls12_nano", device="cpu")
    n, nbits = 5, rctx.host.r.bit_length()
    rcurve, rP = _points(rctx, group, n)
    curve = ctx.g1 if group == "g1" else ctx.g2
    bits = _bits_matrix(n, nbits, 7)
    if shared:
        bits = bits[1]
    # a zero scalar and an all-ones scalar ride along
    if not shared:
        bits[0] = 0
        bits[2] = 1
    want = jax.tree.leaves(rcurve._scalar_mul_bits_impl(
        rP, jnp.asarray(bits.astype(np.uint32))))
    P = from_reference(jax.tree.map(np.asarray, rP), "cpu")
    got = tree_leaves(curve._scalar_mul_bits_impl(P, torch.from_numpy(bits)))
    assert len(got) == len(want) == (3 if group == "g1" else 6)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), to_reference(g))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_ladder_tables_replay_equals_plain_ladder(group, shared):
    ctx = dev_ctx("bls12_nano", device="cpu")
    curve, P = _points(ctx, group, 4)
    nbits = 11
    bits = _bits_matrix(4, nbits, 3 + shared)
    bits = torch.from_numpy(bits[0] if shared else bits)
    want = tree_leaves(curve._scalar_mul_bits_impl(P, bits))
    fl = FusedLadder(ctx, group)
    before = dict(FusedLadder.launches)
    got = tree_leaves(fl.scalar_mul_bits(P, bits))
    # the public entry takes the same path on the CPU
    via_curve = tree_leaves(curve.scalar_mul_bits(P, bits))
    assert FusedLadder.launches == before  # CPU: no launch
    for w, g, v in zip(want, got, via_curve):
        assert torch.equal(w, g)
        assert torch.equal(w, v)
    # and the values are the host's k * P
    host = ctx.host
    hcurve = host.g1 if group == "g1" else host.g2
    pts = (ctx.g1_from_dev if group == "g1" else ctx.g2_from_dev)(
        curve.scalar_mul_bits(P, bits))
    base = (ctx.g1_from_dev if group == "g1" else ctx.g2_from_dev)(P)
    for i, (b, q) in enumerate(zip(base, pts)):
        row = bits if shared else bits[i]
        k = int("".join(str(int(x)) for x in row.tolist()), 2)
        assert q == hcurve.scalar_mul(b, k)


def test_fr_limbs_to_bits_and_scalar_bits_equal_reference():
    import jax

    from ripp_tpu.ops.points import dev_ctx as ref_dev_ctx

    rctx = ref_dev_ctx("bls12_nano")
    ctx = dev_ctx("bls12_nano", device="cpu")
    r = ctx.host.r
    ks = [0, 1, r - 1, 12345, r // 3]
    want = np.asarray(rctx.fr_limbs_to_bits(rctx.t.fr_to_dev(ks)))
    got = ctx.fr_limbs_to_bits(ctx.t.fr_to_dev(ks))
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(
        np.asarray(rctx.scalars_to_bits(ks, 24)),
        ctx.scalars_to_bits(ks, 24).numpy())
    np.testing.assert_array_equal(
        np.asarray(rctx.scalar_bits(r - 2, 24)),
        ctx.scalar_bits(r - 2, 24).numpy())


@pytest.mark.parametrize("n", [1, 5, 8])
def test_sum_reduce_equals_host_sum(n):
    ctx = dev_ctx("bls12_toy", device="cpu")
    host = ctx.host
    pts = [host.g1.scalar_mul(host.g1_gen, 7 * i + 1) for i in range(n)]
    got = ctx.g1_from_dev(tuple(
        x[None] for x in ctx.g1.sum_reduce(ctx.g1_to_dev(pts))))[0]
    want = None
    for p in pts:
        want = host.g1.add(want, p)
    assert got == want
