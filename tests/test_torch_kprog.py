"""ripp_tpu_torch.ops.kprog: the port's IR and scheduler give the SAME
scheduled programs as the JAX package's (segments, register numbers,
constant table), pure Python on both sides; run_torch equals run_host;
the CUDA executor's instruction table round-trips; and the Miller step
programs' counts on BLS12-381 are recorded.

Every comparison is exact: integers and structures, tolerance zero.
"""

import random

import numpy as np
import pytest

from ripp_tpu.host.curves import get_curve as ref_get_curve
from ripp_tpu.ops.pairing_fused import _build_step_progs as ref_step_progs
from ripp_tpu_torch.host.curves import get_curve
from ripp_tpu_torch.ops import kexec, kprog
from ripp_tpu_torch.ops.fp import DevFp, limbs_tensor, make_spec
from ripp_tpu_torch.ops.pairing_fused import _build_step_progs

PROGS = {"dbl": 0, "add": 1}

# Miller step programs on BLS12-381, from the port's schedules (they equal
# the reference's, see test_schedule_equals_reference):
#   muls per group, cheap ops (add/sub/neg), movc, registers
BLS12_381_COUNTS = {
    "dbl": dict(mul_groups=[54, 10, 51], cheap=452, movc=2, n_regs=157),
    "add": dict(mul_groups=[24, 19, 57], cheap=320, movc=4, n_regs=159),
}


def _segments_plain(sched):
    """Segments as plain tuples so two packages' Op classes compare."""
    out = []
    for kind, items in sched.segments:
        if kind == "muls":
            out.append((kind, [tuple(t) for t in items]))
        else:
            out.append((kind, [(o.kind, o.dst, o.a, o.b, o.m) for o in items]))
    return out


@pytest.mark.parametrize("prog", list(PROGS))
@pytest.mark.parametrize("curve_name", ["bls12_toy", "bls12_381"])
def test_schedule_equals_reference(curve_name, prog):
    want = ref_step_progs(ref_get_curve(curve_name))[PROGS[prog]]
    got = _build_step_progs(get_curve(curve_name))[PROGS[prog]]
    assert got.name == want.name
    assert got.n_regs == want.n_regs
    assert got.inputs == want.inputs == list(range(24))
    assert got.mask_inputs == want.mask_inputs == []
    assert got.outputs == want.outputs
    assert got.consts == want.consts
    assert _segments_plain(got) == _segments_plain(want)


@pytest.mark.parametrize("prog", list(PROGS))
def test_step_program_counts_bls12_381(prog):
    sched = _build_step_progs(get_curve("bls12_381"))[PROGS[prog]]
    kinds = {}
    for kind, items in sched.segments:
        if kind == "ops":
            for o in items:
                kinds[o.kind] = kinds.get(o.kind, 0) + 1
    want = BLS12_381_COUNTS[prog]
    assert sched.mul_groups() == want["mul_groups"]
    assert sum(kinds.get(k, 0) for k in ("add", "sub", "neg")) == want["cheap"]
    assert kinds.get("movc", 0) == want["movc"]
    assert kinds.get("sel", 0) == 0
    assert sched.n_regs == want["n_regs"]
    # outputs never lie in the pinned state registers, so the copies back
    # to registers 0..17 cannot overlap
    assert min(sched.outputs) >= 24
    assert len(set(sched.outputs)) == 18


def test_miller_muls_per_pair_bls12_381():
    curve = get_curve("bls12_381")
    dbl, add = _build_step_progs(curve)
    bits = bin(abs(curve.x))[3:]
    assert (len(bits), bits.count("1")) == (63, 5)
    per_pair = len(bits) * sum(dbl.mul_groups()) \
        + bits.count("1") * sum(add.mul_groups())
    assert per_pair == 63 * 115 + 5 * 100 == 7745


def _mixed_prog(curve):
    """Every op kind: an Fp2 product, then d = (c0 - c1, -(c0 + 5))
    selected by a mask (the program of the reference's kexec test)."""
    prog = kprog.KProg("fp2_mul")
    fp, fp2, _, _, _ = kprog.prog_tower(prog, curve)
    a = (prog.inp(), prog.inp())
    b = (prog.inp(), prog.inp())
    c = fp2.mul(a, b)
    d0 = fp.sub(c[0], c[1])
    d1 = fp.neg(fp.add(c[0], fp.const(5)))
    m = prog.mask_inp()
    prog.out([prog.sel(m, d0, d1), c[0], c[1]])
    return kprog.schedule(prog)


@pytest.mark.parametrize("prog", ["dbl", "add", "mixed"])
def test_run_torch_equals_run_host(prog):
    import torch

    curve = get_curve("bls12_toy")
    p = curve.p
    sched = (_mixed_prog(curve) if prog == "mixed"
             else _build_step_progs(curve)[PROGS[prog]])
    rng = random.Random(9)
    n = 5
    ints = [[rng.randrange(p) for _ in range(n)] for _ in sched.inputs]
    mask_bits = [[i % 2 for i in range(n)] for _ in sched.mask_inputs]
    want = kprog.run_host(sched, p, ints, masks=mask_bits)

    spec = make_spec("bls12_toy.fp", p)
    fp = DevFp(spec, "cpu")
    arrs = [limbs_tensor(spec.to_mont_limbs(v), "cpu") for v in ints]
    masks = [torch.tensor(m, dtype=torch.bool) for m in mask_bits]
    got = kprog.run_torch(sched, fp, arrs, masks=masks)
    assert [spec.from_mont_limbs(g) for g in got] == want
    # the plain executor of the encoded table agrees limb for limb
    via_table = kexec.ProgramKernel(fp, sched)(arrs, masks=masks)
    for g, t in zip(got, via_table):
        assert torch.equal(g.expand(t.shape), t)


@pytest.mark.parametrize("prog", ["dbl", "add", "mixed"])
def test_instruction_table_round_trips(prog):
    curve = get_curve("bls12_toy")
    sched = (_mixed_prog(curve) if prog == "mixed"
             else _build_step_progs(curve)[PROGS[prog]])
    tab = kexec.encode_table(sched, const_base=3)
    assert tab.dtype == np.int32 and tab.shape[1] == kexec.TAB_COLS
    n_ops = sum(len(items) for _, items in sched.segments)
    assert tab.shape[0] == n_ops
    back = kexec.decode_table(tab, const_base=3)
    rebuilt = kprog.Scheduled(sched.name, back, sched.n_regs, sched.inputs,
                              sched.mask_inputs, sched.outputs, sched.consts)
    assert _segments_plain(rebuilt) == _segments_plain(sched)
    np.testing.assert_array_equal(
        kexec.mul_table(sched), tab[tab[:, 0] == kexec.OP_MUL][:, 1:4])


def test_copy_rows_direct_and_through_temporaries():
    rows, n = kexec.copy_rows([30, 31, 32], 0, 40)
    assert n == 40 and rows[:, 1].tolist() == [0, 1, 2]
    assert rows[:, 2].tolist() == [30, 31, 32]
    # a source inside the destination range: go through temporaries
    rows, n = kexec.copy_rows([1, 0, 32], 0, 40)
    assert n == 43
    regs = {1: "a", 0: "b", 32: "c"}
    for code, d, a, _, _ in rows.tolist():
        assert code == kexec.OP_COPY
        regs[d] = regs[a]
    assert [regs[k] for k in range(3)] == ["a", "b", "c"]


def test_const_words_pack_the_limbs():
    spec = make_spec("bls12_381.fp", get_curve("bls12_381").p)
    consts = [0, 1, 5, spec.p - 1]
    words = kexec.const_words(spec, consts).view(np.uint32)
    limbs = kexec.const_limbs(spec, consts)
    assert words.shape == (4, spec.nl // 2)
    for w, l in zip(words, limbs):
        v = sum(int(x) << (32 * i) for i, x in enumerate(w))
        assert v == sum(int(x) << (16 * i) for i, x in enumerate(l))
    assert spec.from_mont_limbs(limbs) == consts
