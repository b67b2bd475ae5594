"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run (needs one card)
    python3 chip_smoke.py --quick    # build + checks at small sizes only

Three main paths, all on BLS12-381 at full width (Fp 381 bits, NL = 24;
Fr 255 bits, NL = 16):
  * the inner pairing product Z = prod e(A_i, B_i): `dev_ctx` ->
    `g1/g2_to_dev` -> `DevPairing.multi_pairing` (normalize, fused Miller
    loop, Fp12 product tree, final exponentiation);
  * the SIPP protocol above it: `models.sipp.prove` (per-element 255-bit
    rescale, then log2(n) rounds of two pairing products and a G1 and a
    G2 fold) and `models.sipp.verify` (one batched GT exponentiation, two
    challenge-product vectors over Fr, two Pippenger MSMs, one host
    pairing);
  * TIPA over TIPP (the argument a Groth16 aggregator runs on the proofs'
    A and B): `models.tipa.setup_srs` (fixed-base tables), then
    `tipa.prove(_with_srs_shift)` (log2(n) GIPA rounds of six pairing
    products and four folds, then two KZG openings as MSMs) and
    `tipa.verify(_with_srs_shift)` (one batched GT exponentiation, then
    one PairingCheck: one multi_pairing), under both Montgomery
    multipliers: `dev_ctx(..., fp_kernel="cios16")` (K1) and
    `fp_kernel="hybrid8"` (K1').

Phases (a failure in any of them ends the run with a non-zero exit code
and no result line):
  1. build: compile the CUDA libraries from ripp_tpu_torch/csrc with nvcc,
     one for Fp and one for Fr.
  2. kernels: the paths are driven once at their sizes (multi_pairing at
     each size; SIPP prove and verify at n = 8 and at the full n; TIPP
     with an SRS shift at n = 8 and at the full n under cios16, and
     without one under hybrid8) while the batch (and bit shape) every
     kernel wrapper is given is noted; then each kernel's wrapper is held
     against its plain PyTorch version on the card at every one of those
     shapes, same inputs (numpy from a seed, or the main path's own
     points), exact equality of every limb (integer arithmetic: the
     tolerance is zero); then timed. The kernels held so: the Montgomery
     product (CIOS and hybrid8, which is also held against CIOS) and the
     add / sub / neg helpers (both fields), the program executor, the
     fused Miller loop, the fused ladder (G1 and G2) and the fused GT
     exponentiation. The plain versions of the Miller loop, the ladder and
     the GT exponentiation work element by element, so each runs once
     over all of a kernel's shapes concatenated (a shared scalar repeated
     for each element) and each launch is compared with its slice.
  3. main paths, checked: multi_pairing at n = 8 with two identity pairs
     against the host model (Python bigints); SIPP at n = 8 round by
     round: every (z_l, z_r) against the host model's pairing products
     on the host-folded vectors, verify accepts, and rejects a proof with
     one GT element changed and a wrong claimed value; TIPP at n = 8,
     without and with an SRS shift: round 1's commitments against the
     host model's pairings, the prover's challenges against the
     verifier's, verify accepts, and rejects a proof with one GT element
     changed and a wrong commitment (and a wrong shift).
  4. main paths, full size: multi_pairing at n = 256, 2048, 4096 with
     A_i = a_i*G1, B_i = b_i*G2; the result must equal
     e(G1, G2)^(sum a_i*b_i mod r). SIPP at n = 4096 on the same points
     with r from the seed: product_of_pairings_with_coeffs must equal
     e(G1, G2)^(sum r_i*a_i*b_i mod r), verify(prove(...)) must be True,
     a tampered proof and a wrong value False. TIPP at n = 1024 on the
     first 1024 points: the checks of phase 3 but round 1's, with and
     without a shift; then the same instance under hybrid8, whose proof
     must equal the cios16 proof byte for byte and whose verify must
     accept. Launch counts are set to 0 before each path and read after,
     and every kernel the path runs must have launched (on the hybrid8
     run K1 itself must not). Only then are the per-phase times taken and
     printed (min of 3, host clock with a synchronise inside, fresh input
     buffers): SIPP's and TIPP's steps are timed inside their prove and
     verify through the `step` argument. The product tree and final
     exponentiation are also timed a second way (Fp12 products through the
     stacked tower instead of the program executor) for comparison.

Output: JSON objects, one a line; then the card's name and power limit as
nvidia-smi prints them; then the {"kernels": [...]} line; the last line
is {"ok": true, "device": {...}}.
"""

import argparse
import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20240607
# Published peaks of one H100 SXM used for `bound_ms`: device memory rate,
# and the float32 rate outside the tensor cores as the nearest published
# figure for 32-bit integer multiply-adds (the card runs integer
# multiplies at half that rate, so the operations bound is generous).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps=5, warm=2):
    """Mean milliseconds a call by CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    """Milliseconds of one call on the host clock, synchronised."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return (time.perf_counter() - t0) * 1e3, out


def max_abs_err(got, want):
    """Largest absolute limb difference over two lists of tensors."""
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max().item()))
    return worst


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def table_ops(tab, nw):
    """32-bit integer operations one element spends on an instruction
    table: a product is 2*nw^2 + nw multiply-adds of two operations each;
    add / sub / neg are about 2*nw word additions; the rest moves data."""
    from ripp_tpu_torch.ops import kexec

    codes = np.asarray(tab)[:, 0]
    n_mul = int((codes == kexec.OP_MUL).sum())
    n_cheap = int(((codes == kexec.OP_ADD) | (codes == kexec.OP_SUB)
                   | (codes == kexec.OP_NEG)).sum())
    return n_mul * 2 * (2 * nw * nw + nw) + n_cheap * 2 * nw, n_mul, n_cheap


def random_limbs(rng, spec, n, device):
    """n random canonical field elements as limbs [n, NL] (read as
    Montgomery forms): uniform 16-bit limbs below the modulus's top limb,
    and a top limb drawn below the modulus's, so every value is < p."""
    from ripp_tpu_torch.ops.fp import limbs_tensor

    top = (spec.p.bit_length() - 1) // 16
    arr = np.zeros((n, spec.nl), dtype=np.int32)
    arr[:, :top] = rng.integers(0, 1 << 16, size=(n, top), dtype=np.int32)
    arr[:, top] = rng.integers(0, spec.p >> (16 * top), size=n,
                               dtype=np.int32)
    return limbs_tensor(arr, device)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

class ShapeCensus:
    """While active, note the shape each kernel wrapper is given (the
    wrappers themselves keep only a count of launches)."""

    def __enter__(self):
        from ripp_tpu_torch.ops import fp_cuda
        from ripp_tpu_torch.ops.curve_fused import FusedLadder
        from ripp_tpu_torch.ops.kexec import ProgramKernel
        from ripp_tpu_torch.ops.pairing_fused import FusedGtExp, FusedMiller

        self.fp_mul, self.fp_cheap, self.kexec = set(), set(), set()
        self.miller, self.ladder, self.gtexp = set(), set(), set()
        self.fp_mul_hybrid8 = set()
        self._saved = (fp_cuda.fp_mul, fp_cuda.fp_cheap,
                       ProgramKernel._launch, FusedMiller._launch,
                       FusedLadder._launch, FusedGtExp._launch,
                       fp_cuda.fp_mul_hybrid8)
        (fp_mul, fp_cheap, k_launch, m_launch, l_launch,
         g_launch, fp_mul_h8) = self._saved

        def batch_of(a, b):
            shape = torch.broadcast_shapes(a.shape, b.shape)
            return int(np.prod(shape[:-1], dtype=np.int64))

        def seen_fp_mul(spec, a, b):
            self.fp_mul.add((spec.name, batch_of(a, b)))
            return fp_mul(spec, a, b)

        def seen_fp_mul_h8(spec, a, b):
            self.fp_mul_hybrid8.add((spec.name, batch_of(a, b)))
            return fp_mul_h8(spec, a, b)

        def seen_fp_cheap(spec, op, a, b):
            self.fp_cheap.add((spec.name, op, batch_of(a, b)))
            return fp_cheap(spec, op, a, b)

        def seen_kexec(kern, inputs, masks, bshape):
            self.kexec.add((kern.sched.name,
                            int(np.prod(bshape, dtype=np.int64))))
            return k_launch(kern, inputs, masks, bshape)

        def seen_miller(fm, xP, yP, qx, qy):
            self.miller.add(int(np.prod(xP.shape[:-1], dtype=np.int64)))
            return m_launch(fm, xP, yP, qx, qy)

        def seen_ladder(fl, flat, bits):
            self.ladder.add((fl.group,
                             int(np.prod(flat[0].shape[:-1], dtype=np.int64)),
                             int(bits.shape[-1]), bits.dim() == 1))
            return l_launch(fl, flat, bits)

        def seen_gtexp(fg, leaves, bits):
            self.gtexp.add((int(bits.shape[0]), int(bits.shape[1])))
            return g_launch(fg, leaves, bits)

        fp_cuda.fp_mul = seen_fp_mul
        fp_cuda.fp_mul_hybrid8 = seen_fp_mul_h8
        fp_cuda.fp_cheap = seen_fp_cheap
        ProgramKernel._launch = seen_kexec
        FusedMiller._launch = seen_miller
        FusedLadder._launch = seen_ladder
        FusedGtExp._launch = seen_gtexp
        return self

    def __exit__(self, *exc):
        from ripp_tpu_torch.ops import fp_cuda
        from ripp_tpu_torch.ops.curve_fused import FusedLadder
        from ripp_tpu_torch.ops.kexec import ProgramKernel
        from ripp_tpu_torch.ops.pairing_fused import FusedGtExp, FusedMiller

        (fp_cuda.fp_mul, fp_cuda.fp_cheap, ProgramKernel._launch,
         FusedMiller._launch, FusedLadder._launch,
         FusedGtExp._launch, fp_cuda.fp_mul_hybrid8) = self._saved
        return False


def main_path_shapes(ctx, hctx, dp, sizes, fixtures, sipp_sizes,
                     tipp_sizes):
    """Drive multi_pairing once at each size, SIPP prove + verify at each
    SIPP size, and TIPP setup + prove + verify at each TIPP size (with an
    SRS shift in the cios16 context `ctx`, which runs every launch of the
    unshifted path too, and without one in the hybrid8 context `hctx`);
    return the shapes the kernels were given."""
    from ripp_tpu_torch.models import sipp

    _, _, A, B, r = fixtures
    P_all, Q_all = ctx.g1_to_dev(A), ctx.g2_to_dev(B)
    with ShapeCensus() as seen:
        for n in sizes:
            dp.multi_pairing(
                tuple(x[:n].clone() for x in P_all),
                tuple(tuple(c[:n].clone() for c in q) for q in Q_all))
        for n in sipp_sizes:
            value = sipp_value(ctx, A[:n], B[:n], r[:n])
            proof = sipp.prove(ctx, A[:n], B[:n], r[:n], value)
            if not sipp.verify(ctx, A[:n], B[:n], r[:n], value, proof):
                raise AssertionError(f"SIPP verify failed at n = {n}")
        for n in tipp_sizes:
            for c, r_shift in ((ctx, tipp_shift(ctx)), (hctx, 1)):
                inst = tipp_instance(c, A[:n], B[:n], tipp_srs(c, n),
                                     r_shift)
                if not tipp_verify(inst, tipp_prove(inst)):
                    raise AssertionError(
                        f"TIPP verify failed at n = {n} ({c.fp_kernel})")
        sync()
    return seen


def check_mont_mul(ctx, batches, n_rate, kernel, plain, name, replaces,
                   seed, also=None):
    """A Montgomery-multiply kernel against its plain version (and, where
    `also` = (tag, other kernel) is given, against that kernel too) at
    every (field, batch) of `batches` (those the main paths give it), with
    the edge operands 0, 1, p-1, R mod p, also against bigints, for the
    base field and the scalar field; timed (beside `also`) at the largest
    batch of each, the bound counted as for the CIOS body; `n_rate`
    elements only for the elements-a-second figures."""
    from ripp_tpu_torch.ops.fp import limbs_tensor

    others = [plain] + ([also[1]] if also else [])
    rng = np.random.default_rng(seed)
    fields = {}
    for spec in (ctx.t.spec_fp, ctx.t.spec_fr):
        field = spec.name
        p = spec.p
        ev = [0, 1, p - 1, spec.r % p]
        edge = limbs_tensor(spec.to_mont_limbs(ev), ctx.device)
        ea, eb = edge.repeat_interleave(4, dim=0), edge.repeat(4, 1)
        got = kernel(spec, ea, eb)
        if max(max_abs_err([got], [f(spec, ea, eb)]) for f in others):
            raise AssertionError(f"{name}[{field}] edge products differ "
                                 "from the plain version")
        if spec.from_mont_limbs(got) != [x * y % p for x in ev for y in ev]:
            raise AssertionError(f"{name}[{field}] edge products != bigints")
        mine = sorted(b for f, b in batches if f == field)
        if not mine:
            raise AssertionError(f"the main paths gave {name} no {field} "
                                 "products")
        for n in mine:
            a = random_limbs(rng, spec, n, ctx.device)
            b = random_limbs(rng, spec, n, ctx.device)
            # the edge operands ride in the first lanes where there is room
            k = min(n, 16)
            a[:k], b[:k] = ea[:k], eb[:k]
            got = kernel(spec, a, b)
            err = max(max_abs_err([got], [f(spec, a, b)]) for f in others)
            if err:
                raise AssertionError(f"{name}[{field}] differs from its plain "
                                     f"version at batch {n}: {err}")
        n_time = max(mine)
        ta = random_limbs(rng, spec, n_time, ctx.device)
        tb = random_limbs(rng, spec, n_time, ctx.device)
        nw = spec.nl // 2
        bms, by = bound(3 * 4 * spec.nl * n_time,
                        n_time * 2 * (2 * nw * nw + nw))
        fields[field] = {
            "checked_batches": mine, "shape": [n_time, spec.nl],
            "ms": time_ms(lambda: kernel(spec, ta, tb), reps=20),
            "plain_ms": time_ms(lambda: plain(spec, ta, tb), reps=2, warm=1),
            "bound_ms": bms, "bound_by": by}
        if also:
            fields[field][f"{also[0]}_ms"] = time_ms(
                lambda: also[1](spec, ta, tb), reps=20)
    spec = ctx.t.spec_fp
    ra = random_limbs(rng, spec, n_rate, ctx.device)
    rb = random_limbs(rng, spec, n_rate, ctx.device)
    main = fields[spec.name]
    row = {
        "name": name, "route": "cuda",
        "source": "ripp_tpu_torch/csrc/fp_mul.cu", "replaces": replaces,
        "equal": True, "max_abs_err": 0,
        "shape": main["shape"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "fields": fields,
        "elements_per_s": n_rate / (
            time_ms(lambda: kernel(spec, ra, rb), reps=20) * 1e-3),
        "elements_per_s_at": n_rate,
    }
    if also:
        tag = also[0]
        row[f"equal_to_{tag}"] = True
        row[f"{tag}_ms"] = main[f"{tag}_ms"]
        row[f"{tag}_elements_per_s"] = n_rate / (
            time_ms(lambda: also[1](spec, ra, rb), reps=20) * 1e-3)
    return row


def check_fp_cheap(ctx, plain_ctx, shapes):
    """The add / sub / neg kernel against the plain ops (plain_add /
    plain_sub / plain_neg through a plain field) at every (field, op,
    batch) of `shapes` (those the main paths give it), with the edge
    operands, for the base field and the scalar field; each op timed at
    the largest batch of its field."""
    from ripp_tpu_torch.ops import fp_cuda
    from ripp_tpu_torch.ops.fp import limbs_tensor

    def plain(pfp, op, a, b):
        return pfp.neg(a) if op == "neg" else getattr(pfp, op)(a, b)

    rng = np.random.default_rng(SEED + 6)
    timed = []
    for fp, pfp in ((ctx.t.fp, plain_ctx.t.fp), (ctx.t.fr, plain_ctx.t.fr)):
        spec = fp.spec
        mine = sorted((op, n) for f, op, n in shapes if f == spec.name)
        if not mine:
            continue
        p = spec.p
        ev = [0, 1, p - 1, spec.r % p]
        edge = limbs_tensor(spec.to_mont_limbs(ev), ctx.device)
        ea, eb = edge.repeat_interleave(4, dim=0), edge.repeat(4, 1)
        exact = {"add": [(x + y) % p for x in ev for y in ev],
                 "sub": [(x - y) % p for x in ev for y in ev],
                 "neg": [-x % p for x in ev for _ in ev]}
        for op in sorted({op for op, _ in mine}):
            got = fp_cuda.fp_cheap(spec, op, ea, eb)
            if (spec.from_mont_limbs(got) != exact[op]
                    or max_abs_err([got], [plain(pfp, op, ea, eb)])):
                raise AssertionError(
                    f"fp_cheap[{spec.name}, {op}] edge operands differ")
        for op, n in mine:
            a = random_limbs(rng, spec, n, ctx.device)
            b = random_limbs(rng, spec, n, ctx.device)
            k = min(n, 16)
            a[:k], b[:k] = ea[:k], eb[:k]
            err = max_abs_err([fp_cuda.fp_cheap(spec, op, a, b)],
                              [plain(pfp, op, a, b)])
            if err:
                raise AssertionError(
                    f"fp_cheap[{spec.name}, {op}] differs from its plain "
                    f"version at batch {n}: {err}")
        n_time = max(n for _, n in mine)
        ta = random_limbs(rng, spec, n_time, ctx.device)
        tb = random_limbs(rng, spec, n_time, ctx.device)
        nw = spec.nl // 2
        for op in sorted({op for op, _ in mine}):
            ms = time_ms(lambda: fp_cuda.fp_cheap(spec, op, ta, tb), reps=20)
            plain_ms = time_ms(lambda: plain(pfp, op, ta, tb), reps=5)
            n_in = 1 if op == "neg" else 2
            bms, by = bound((n_in + 1) * 4 * spec.nl * n_time,
                            n_time * 2 * nw)
            timed.append({"field": spec.name, "op": op, "batch": n_time,
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                          "bound_by": by})
    # the row's own figures: an add at the largest base-field batch
    main = next(t for t in timed
                if t["field"] == ctx.t.spec_fp.name and t["op"] == "add")
    return {
        "name": "fp_cheap", "route": "cuda",
        "source": "ripp_tpu_torch/csrc/fp_mul.cu",
        "replaces": "ripp_tpu/ops/fp.py:248",
        "note": "DevFp.add / sub / neg there are XLA ops, no pallas_call",
        "equal": True, "max_abs_err": 0,
        "shape": [main["batch"], ctx.t.spec_fp.nl], "op": "add",
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "checked_shapes": [list(x) for x in sorted(shapes)],
        "timed": timed,
    }


def check_kexec(ctx, plain_ctx, dp, shapes, n_step):
    """The program executor against the plain executor: the Fp12 programs
    at every (program, batch) of `shapes` (those the main paths give it)
    and the two Miller step programs at `n_step` elements."""
    from ripp_tpu_torch.ops.kexec import ProgramKernel

    spec = ctx.t.spec_fp
    nw = spec.nl // 2
    rng = np.random.default_rng(SEED + 1)
    fm = dp.fused
    by_name = {k.sched.name: k for k in dp._build_f12_kernels()}
    cases = [(ProgramKernel(ctx.t.fp, fm.dbl_sched), n_step),
             (ProgramKernel(ctx.t.fp, fm.add_sched), n_step)]
    cases += [(by_name[name], n) for name, n in sorted(shapes)]
    programs = []
    for kern, n in cases:
        sched = kern.sched
        plain = ProgramKernel(plain_ctx.t.fp, sched, plain=True)
        ins = [random_limbs(rng, spec, n, ctx.device)
               for _ in sched.inputs]
        got = kern(ins)
        sync()
        ms_plain, want = host_ms(lambda: plain(ins))
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(
                f"kexec[{sched.name}] differs from its plain version at "
                f"batch {n}: {err}")
        ms = time_ms(lambda: kern(ins), reps=10)
        ops, n_mul, n_cheap = table_ops(kern.table, nw)
        bms, by = bound(
            (len(sched.inputs) + len(sched.outputs)) * 4 * spec.nl * n,
            ops * n)
        programs.append({
            "program": sched.name, "batch": n, "ms": ms,
            "plain_ms": ms_plain, "bound_ms": bms, "bound_by": by,
            "muls": n_mul, "cheap_ops": n_cheap, "n_regs": sched.n_regs,
            "rows": int(kern.table.shape[0])})
    # the row's own figures: the largest launch the main paths make
    main = max((r for r in programs if r["program"] == "fp12_mul"),
               key=lambda r: r["batch"])
    return {
        "name": "kexec", "route": "cuda",
        "source": "ripp_tpu_torch/csrc/kexec.cu",
        "replaces": "ripp_tpu/ops/kexec.py:247",
        "equal": True, "max_abs_err": 0,
        "shape": [main["batch"], spec.nl], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "programs": programs,
    }


def check_miller(ctx, dp, plain_dp, batches, affine):
    """The fused Miller kernel against the plain loop at every batch of
    `batches`, on the main path's own affine points (the first n of
    `affine` for a batch of n). The plain loop runs once over all the
    batches concatenated; each launch is compared with its slice. Timed
    at every batch."""
    from ripp_tpu_torch.ops.tower import tree_leaves, tree_map

    spec = ctx.t.spec_fp
    nw = spec.nl // 2
    fm = dp.fused
    sizes = sorted(batches)
    cat = tree_map(lambda x: torch.cat([x[:n] for n in sizes]), affine)
    plain_ms, want = host_ms(lambda: tree_leaves(plain_dp._miller_impl(*cat)))
    checked = []
    off = 0
    for n in sizes:
        ins = tree_map(lambda x: x[:n].contiguous(), affine)
        got = tree_leaves(fm.miller(*ins))
        err = max_abs_err(got, [w[off:off + n] for w in want])
        if err:
            raise AssertionError(
                f"fused Miller differs from the plain loop at {n} pairs: "
                f"{err}")
        off += n
        ms = time_ms(lambda: fm.miller(*ins), reps=3, warm=1)
        checked.append({"pairs": n, "ms": ms})
    d_ops, d_mul, d_cheap = table_ops(fm.dbl_table, nw)
    a_ops, a_mul, a_cheap = table_ops(fm.add_table, nw)
    n_dbl, n_add = len(fm.x_bits), sum(fm.x_bits)
    ops = n_dbl * d_ops + n_add * a_ops
    top = checked[-1]
    n = top["pairs"]
    bms, by = bound((6 + 12) * 4 * spec.nl * n, ops * n)
    return {
        "name": "fused_miller", "route": "cuda",
        "source": "ripp_tpu_torch/csrc/miller.cu",
        "replaces": "ripp_tpu/ops/pairing_fused.py:327",
        "equal": True, "max_abs_err": 0,
        "checked": checked, "shape": [n, spec.nl], "ms": top["ms"],
        "plain_ms": plain_ms, "plain_pairs": int(off),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "pairs_per_s": n / (top["ms"] * 1e-3),
        "muls_per_pair": n_dbl * d_mul + n_add * a_mul,
        "cheap_ops_per_pair": n_dbl * d_cheap + n_add * a_cheap,
        "n_regs": fm.n_regs,
    }


def random_bits(rng, shape, device):
    return torch.from_numpy(
        rng.integers(0, 2, size=shape, dtype=np.uint8)).to(device)


def check_ladder(ctx, plain_ctx, group, shapes, points):
    """The fused ladder of one group against the plain double-and-add at
    every (batch, nbits, shared) of `shapes`, on the main path's own
    points (the first n of `points`) with bits drawn from the seed. One
    plain run per bit length over all its shapes concatenated (a shared
    scalar repeated for each element). Timed at every shape."""
    from ripp_tpu_torch.ops.curve_fused import fused_ladder
    from ripp_tpu_torch.ops.tower import tree_leaves, tree_map

    spec = ctx.t.spec_fp
    nw = spec.nl // 2
    fl = fused_ladder(ctx, group)
    pcurve = plain_ctx.g1 if group == "g1" else plain_ctx.g2
    rng = np.random.default_rng(SEED + 2 + (group == "g2"))
    mine = sorted((b, nb, sh) for g, b, nb, sh in shapes if g == group)
    rows = []
    plain_runs = []
    for nbits in sorted({nb for _, nb, _ in mine}):
        cases = [(b, sh) for b, nb, sh in mine if nb == nbits]
        ins, bits, per_elem = [], [], []
        for b, sh in cases:
            ins.append(tree_map(lambda x: x[:b].contiguous(), points))
            bt = random_bits(rng, (nbits,) if sh else (b, nbits), ctx.device)
            bits.append(bt)
            per_elem.append(bt.expand(b, nbits) if sh else bt)
        cat = tree_map(lambda *xs: torch.cat(xs), *ins)
        pms, want = host_ms(lambda: tree_leaves(pcurve._scalar_mul_bits_impl(
            cat, torch.cat(per_elem))))
        plain_runs.append({"nbits": nbits, "elements": int(
            sum(b for b, _ in cases)), "plain_ms": pms})
        off = 0
        for (b, sh), P, bt in zip(cases, ins, bits):
            got = tree_leaves(fl.scalar_mul_bits(P, bt))
            err = max_abs_err(got, [w[off:off + b] for w in want])
            if err:
                raise AssertionError(
                    f"fused ladder {group} differs from the plain ladder at "
                    f"{b} x {nbits} bits (shared={sh}): {err}")
            off += b
            ms = time_ms(lambda: fl.scalar_mul_bits(P, bt), reps=3, warm=1)
            d_ops, _, _ = table_ops(fl.dbl_table, nw)
            a_ops, _, _ = table_ops(fl.add_table, nw)
            n_io = 6 * fl.d * 4 * spec.nl * b + (nbits if sh else nbits * b)
            bms, by = bound(n_io, nbits * (d_ops + a_ops) * b)
            rows.append({"batch": b, "nbits": nbits, "shared": sh, "ms": ms,
                         "bound_ms": bms, "bound_by": by,
                         "plain_ms_of_run": pms})
    # the row's own figures: the rescale (per element) for g1, the
    # largest fold for g2
    main = max(rows, key=lambda r: (not r["shared"], r["batch"]))
    _, d_mul, d_cheap = table_ops(fl.dbl_table, nw)
    _, a_mul, a_cheap = table_ops(fl.add_table, nw)
    return {
        "name": f"fused_ladder_{group}", "route": "cuda",
        "source": "ripp_tpu_torch/csrc/ladder.cu",
        "replaces": "ripp_tpu/ops/curve_fused.py:195",
        "equal": True, "max_abs_err": 0,
        "shape": [main["batch"], main["nbits"]], "shared": main["shared"],
        "ms": main["ms"], "plain_ms": main["plain_ms_of_run"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "checked": rows, "plain_runs": plain_runs,
        "muls_per_bit": d_mul + a_mul, "cheap_ops_per_bit": d_cheap + a_cheap,
        "n_regs": fl.n_regs,
    }


def check_gtexp(ctx, plain_dp, dp, shapes):
    """The fused GT exponentiation against the plain square and multiply
    at every (batch, nbits) of `shapes`, on random Fp12 values and bits
    from the seed (the step is the same for any Fp12 value). One plain run
    over all shapes concatenated. Timed at every shape."""
    from ripp_tpu_torch.ops.pairing_fused import fused_gtexp
    from ripp_tpu_torch.ops.tower import tree_leaves

    spec = ctx.t.spec_fp
    nw = spec.nl // 2
    fg = fused_gtexp(ctx)
    rng = np.random.default_rng(SEED + 5)
    rows = []
    plain_runs = []
    for nbits in sorted({nb for _, nb in shapes}):
        cases = sorted(b for b, nb in shapes if nb == nbits)
        ins = [[random_limbs(rng, spec, b, ctx.device) for _ in range(12)]
               for b in cases]
        bits = [random_bits(rng, (b, nbits), ctx.device) for b in cases]
        cat = dp._nest12([torch.cat(xs) for xs in zip(*ins)])
        pms, want = host_ms(lambda: tree_leaves(
            plain_dp.gt_exp_tree(cat, torch.cat(bits))))
        plain_runs.append({"nbits": nbits, "elements": int(sum(cases)),
                           "plain_ms": pms})
        off = 0
        for b, leaves, bt in zip(cases, ins, bits):
            f = dp._nest12(leaves)
            got = tree_leaves(fg(f, bt))
            err = max_abs_err(got, [w[off:off + b] for w in want])
            if err:
                raise AssertionError(
                    f"fused GT exp differs from the plain loop at "
                    f"{b} x {nbits} bits: {err}")
            off += b
            ms = time_ms(lambda: fg(f, bt), reps=3, warm=1)
            ops, _, _ = table_ops(fg.table, nw)
            bms, by = bound(24 * 4 * spec.nl * b + nbits * b,
                            nbits * ops * b)
            rows.append({"batch": b, "nbits": nbits, "ms": ms,
                         "bound_ms": bms, "bound_by": by,
                         "plain_ms_of_run": pms})
    main = max(rows, key=lambda r: r["batch"])
    _, n_mul, n_cheap = table_ops(fg.table, nw)
    return {
        "name": "fused_gtexp", "route": "cuda",
        "source": "ripp_tpu_torch/csrc/gtexp.cu",
        "replaces": "ripp_tpu/ops/pairing_fused.py:544",
        "equal": True, "max_abs_err": 0,
        "shape": [main["batch"], main["nbits"]], "ms": main["ms"],
        "plain_ms": main["plain_ms_of_run"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "checked": rows, "plain_runs": plain_runs,
        "muls_per_bit": n_mul, "cheap_ops_per_bit": n_cheap,
        "n_regs": fg.n_regs,
    }


# ---------------------------------------------------------------------------
# phases 3 and 4: the main paths
# ---------------------------------------------------------------------------

# the kernels each main path must launch (K1 must not launch on the
# hybrid8 run: checked in main)
PATH_KERNELS = {
    "multi_pairing": ("fp_mul", "fp_cheap", "kexec", "fused_miller"),
    "sipp": ("fp_mul", "fp_cheap", "kexec", "fused_miller",
             "fused_ladder_g1", "fused_ladder_g2", "fused_gtexp"),
    "tipp": ("fp_mul", "fp_cheap", "kexec", "fused_miller",
             "fused_ladder_g1", "fused_ladder_g2", "fused_gtexp"),
    "tipp_hybrid8": ("fp_mul_hybrid8", "fp_cheap", "kexec", "fused_miller",
                     "fused_ladder_g1", "fused_ladder_g2", "fused_gtexp"),
}


def reset_counts():
    from ripp_tpu_torch.ops import fp_cuda
    from ripp_tpu_torch.ops.curve_fused import FusedLadder
    from ripp_tpu_torch.ops.kexec import ProgramKernel
    from ripp_tpu_torch.ops.pairing_fused import FusedGtExp, FusedMiller

    fp_cuda.launches = 0
    fp_cuda.hybrid8_launches = 0
    fp_cuda.cheap_launches = 0
    ProgramKernel.launches = 0
    FusedMiller.launches = 0
    FusedLadder.launches = {"g1": 0, "g2": 0}
    FusedGtExp.launches = 0


def read_counts():
    from ripp_tpu_torch.ops import fp_cuda
    from ripp_tpu_torch.ops.curve_fused import FusedLadder
    from ripp_tpu_torch.ops.kexec import ProgramKernel
    from ripp_tpu_torch.ops.pairing_fused import FusedGtExp, FusedMiller

    return {"fp_mul": fp_cuda.launches,
            "fp_mul_hybrid8": fp_cuda.hybrid8_launches,
            "kexec": ProgramKernel.launches,
            "fused_miller": FusedMiller.launches,
            "fused_ladder_g1": FusedLadder.launches["g1"],
            "fused_ladder_g2": FusedLadder.launches["g2"],
            "fused_gtexp": FusedGtExp.launches,
            "fp_cheap": fp_cuda.cheap_launches}


def main_checked(ctx, dp):
    from ripp_tpu_torch.host import pairing as hp

    host = ctx.host
    rng = random.Random(SEED + 3)
    A = [host.g1.scalar_mul(host.g1_gen, rng.randrange(1, host.r))
         for _ in range(8)]
    B = [host.g2.scalar_mul(host.g2_gen, rng.randrange(1, host.r))
         for _ in range(8)]
    A[2] = None
    B[5] = None
    got = dp.multi_pairing(ctx.g1_to_dev(A), ctx.g2_to_dev(B))
    want = hp.multi_pairing(host, A, B)
    if got != want:
        raise AssertionError("multi_pairing(n=8) differs from the host model")
    emit({"phase": "main_checked", "n": 8, "identity_pairs": 2,
          "equal_to_host_model": True})


def sipp_value(ctx, A, B, r):
    from ripp_tpu_torch.models import sipp
    from ripp_tpu_torch.models.vectors import FrVec, PointVec

    return sipp.product_of_pairings_with_coeffs(
        ctx, PointVec.from_host(ctx, "g1", A),
        PointVec.from_host(ctx, "g2", B), FrVec.from_ints(ctx, r))


def tampered(host, proof):
    """The proof with one GT element changed (squared: still in GT)."""
    from ripp_tpu_torch.models import sipp

    elems = list(proof.gt_elems)
    k = len(elems) // 2
    z_l, z_r = elems[k]
    elems[k] = (z_l, host.tower.fp12.mul(z_r, z_r))
    return sipp.SIPPProof(gt_elems=elems)


def sipp_checked(ctx, fixtures, n=8):
    """SIPP at n = 8, every round against the host model: z_l, z_r are
    the host's pairing products on the host-folded vectors."""
    from ripp_tpu_torch.host import pairing as hp
    from ripp_tpu_torch.models import sipp
    from ripp_tpu_torch.utils.fiat_shamir import FiatShamirRng
    from ripp_tpu_torch.utils.serialize import CurveSerializer

    host = ctx.host
    _, _, A, B, r = fixtures
    A, B, r = A[:n], B[:n], r[:n]
    value = sipp_value(ctx, A, B, r)
    a = [host.g1.scalar_mul(p, k) for p, k in zip(A, r)]
    b = list(B)
    if value != hp.multi_pairing(host, a, b):
        raise AssertionError("SIPP(n=8): the claimed value != host model")
    proof = sipp.prove(ctx, A, B, r, value)
    s = CurveSerializer(host)
    rng = FiatShamirRng(sipp._instance_seed(ctx, A, B, r, value))
    for i, (z_l, z_r) in enumerate(proof.gt_elems):
        h = len(a) // 2
        a_l, a_r, b_l, b_r = a[:h], a[h:], b[:h], b[h:]
        if (z_l != hp.multi_pairing(host, a_r, b_l)
                or z_r != hp.multi_pairing(host, a_l, b_r)):
            raise AssertionError(f"SIPP(n=8) round {i} != host model")
        rng.absorb(s.gt(z_l) + s.gt(z_r))
        x = rng.next_u128()
        x_inv = pow(x, -1, host.r)
        a = [host.g1.add(host.g1.scalar_mul(p, x), q)
             for p, q in zip(a_r, a_l)]
        b = [host.g2.add(host.g2.scalar_mul(p, x_inv), q)
             for p, q in zip(b_r, b_l)]
    if len(a) != 1:
        raise AssertionError("SIPP(n=8): wrong number of rounds")
    wrong = hp.gt_mul(host, value, value)
    result = {
        "honest": sipp.verify(ctx, A, B, r, value, proof),
        "tampered": sipp.verify(ctx, A, B, r, value, tampered(host, proof)),
        "wrong_value": sipp.verify(ctx, A, B, r, wrong, proof),
    }
    if result != {"honest": True, "tampered": False, "wrong_value": False}:
        raise AssertionError(f"SIPP(n=8) verify: {result}")
    emit({"phase": "sipp_checked", "n": n, "rounds": len(proof.gt_elems),
          "rounds_equal_to_host_model": True, "verify": result})


def main_full(ctx, dp, sizes, fixtures):
    """Drive multi_pairing at each size, check it, then time its phases.
    Returns the launch counts of the checked runs (all sizes together)."""
    from ripp_tpu_torch.host import pairing as hp

    host = ctx.host
    a, b, A, B, _ = fixtures
    e_gen = hp.pairing(host, host.g1_gen, host.g2_gen)
    P_all, Q_all = ctx.g1_to_dev(A), ctx.g2_to_dev(B)
    sync()

    def batch(n):
        return (tuple(x[:n].clone() for x in P_all),
                tuple(tuple(c[:n].clone() for c in q) for q in Q_all))

    reset_counts()
    for n in sizes:
        P, Q = batch(n)
        got = dp.multi_pairing(P, Q)
        s = sum(x * y for x, y in zip(a[:n], b[:n])) % host.r
        if got != hp.gt_exp(host, e_gen, s):
            raise AssertionError(
                f"multi_pairing(n={n}) != e(G1,G2)^(sum a_i b_i)")
    sync()
    counts = read_counts()
    emit({"phase": "main_full_checked", "sizes": list(sizes),
          "equal_to_generator_power": True, "launches": counts})

    # times, after the check: fresh input buffers for each timed run
    for n in sizes:
        rows = {"normalize_ms": [], "miller_ms": [], "product_ms": [],
                "final_exp_ms": [], "total_ms": []}
        for _ in range(3):
            P, Q = batch(n)
            t_norm, (g1a, g2a) = host_ms(
                lambda: (ctx.g1.normalize(P), ctx.g2.normalize(Q)))
            t_mil, f = host_ms(lambda: dp.miller_batch(g1a, g2a))
            t_prod, prod = host_ms(lambda: dp.product_reduce(f))
            t_fin, _ = host_ms(lambda: dp.finalize_product(prod))
            P, Q = batch(n)
            t_all, _ = host_ms(lambda: dp.multi_pairing(P, Q))
            for k, v in zip(rows, (t_norm, t_mil, t_prod, t_fin, t_all)):
                rows[k].append(v)
        best = {k: min(v) for k, v in rows.items()}
        emit({"phase": "main_full_times", "n": n, **best,
              "pairs_per_s_miller_product":
                  n / ((best["miller_ms"] + best["product_ms"]) * 1e-3),
              "pairs_per_s_end_to_end": n / (best["total_ms"] * 1e-3),
              "runs": rows,
              "timing": "host clock around synchronised calls, min of 3"})
    fp12_routes(ctx, dp, batch(max(sizes)))
    return counts


def fp12_routes(ctx, dp, inputs):
    """Time the product tree and the final exponentiation with the Fp12
    products taken two ways on the same Miller values: as programs of the
    executor (what multi_pairing does on the card) and through the stacked
    tower (one Montgomery launch and the add / sub / neg launches a
    product). The results must agree."""
    from ripp_tpu_torch.ops.pairing import DevPairing

    tower = DevPairing(ctx)
    tower.f12_mul, tower.f12_sqr = tower.fp12.mul, tower.fp12.sqr
    P, Q = inputs
    f = dp.miller_batch(ctx.g1.normalize(P), ctx.g2.normalize(Q))
    out = {"phase": "fp12_routes", "n": int(P[0].shape[0]),
           "timing": "host clock around synchronised calls, min of 3"}
    results = []
    for name, d in (("programs", dp), ("tower", tower)):
        t_prod, t_fin = [], []
        for _ in range(3):
            reset_counts()
            t, prod = host_ms(lambda: d.product_reduce(f))
            t_prod.append(t)
            t, z = host_ms(lambda: d.finalize_product(prod))
            t_fin.append(t)
        results.append(z)
        out[name] = {"product_ms": min(t_prod), "final_exp_ms": min(t_fin),
                     "product_runs": t_prod, "final_exp_runs": t_fin,
                     "launches": read_counts()}
    if results[0] != results[1]:
        raise AssertionError("the two Fp12 routes disagree")
    emit(out)


def sipp_full(ctx, fixtures, n):
    """SIPP at n: the claimed value against the generator power, then
    prove + verify with the launch counts set to 0 before and read after,
    then the rejections; only then the times. Returns the counts."""
    from ripp_tpu_torch.host import pairing as hp
    from ripp_tpu_torch.models import sipp

    host = ctx.host
    a, b, A, B, r = fixtures
    A, B, r = A[:n], B[:n], r[:n]
    value = sipp_value(ctx, A, B, r)
    s = sum(ri * x * y for ri, x, y in zip(r, a, b)) % host.r
    if value != hp.gt_exp(host, hp.pairing(host, host.g1_gen, host.g2_gen),
                          s):
        raise AssertionError(
            f"product_of_pairings_with_coeffs(n={n}) != "
            "e(G1,G2)^(sum r_i a_i b_i)")
    sync()
    reset_counts()
    proof = sipp.prove(ctx, A, B, r, value)
    ok = sipp.verify(ctx, A, B, r, value, proof)
    sync()
    counts = read_counts()
    wrong = hp.gt_mul(host, value, value)
    result = {
        "honest": ok,
        "tampered": sipp.verify(ctx, A, B, r, value, tampered(host, proof)),
        "wrong_value": sipp.verify(ctx, A, B, r, wrong, proof),
    }
    if result != {"honest": True, "tampered": False, "wrong_value": False}:
        raise AssertionError(f"SIPP(n={n}) verify: {result}")
    emit({"phase": "sipp_full_checked", "n": n,
          "value_equal_to_generator_power": True, "verify": result,
          "rounds": len(proof.gt_elems), "launches": counts})
    sipp_times(ctx, A, B, r, value, proof)
    return counts


class StepTimer:
    """The `step` argument of sipp.prove / sipp.verify: runs each step
    between two synchronises and notes its host-clock time, in order."""

    def __init__(self):
        self.events = []

    def __call__(self, name, fn):
        ms, out = host_ms(fn)
        self.events.append((name, ms))
        return out

    def totals(self):
        out = {}
        for name, ms in self.events:
            out[name] = out.get(name, 0.0) + ms
        return out

    def rounds(self):
        """Per round of prove_rounds: its size and step times."""
        rows = []
        for name, ms in self.events:
            if name == "round_pairings":
                rows.append({"pairings_ms": ms})
            elif name in ("fold_g1", "fold_g2"):
                rows[-1][name + "_ms"] = ms
        return rows


def sipp_times(ctx, A, B, r, value, proof):
    """Min of 3 on the host clock of prove and verify as a whole, then of
    each of their steps, timed inside the two functions by a StepTimer
    (which synchronises around every step, so the totals are taken
    without it). One line a step."""
    from ripp_tpu_torch.models import sipp

    n = len(A)
    totals = {"prove_ms": [], "verify_ms": []}
    for _ in range(3):
        ms, pf = host_ms(lambda: sipp.prove(ctx, A, B, r, value))
        totals["prove_ms"].append(ms)
        ms, ok = host_ms(lambda: sipp.verify(ctx, A, B, r, value, pf))
        totals["verify_ms"].append(ms)
        if pf.gt_elems != proof.gt_elems or not ok:
            raise AssertionError("a timed prove / verify gave another result")
    steps = {"prove": [], "verify": []}
    rounds = []
    for _ in range(3):
        tp, tv = StepTimer(), StepTimer()
        pf = sipp.prove(ctx, A, B, r, value, step=tp)
        ok = sipp.verify(ctx, A, B, r, value, pf, step=tv)
        if pf.gt_elems != proof.gt_elems or not ok:
            raise AssertionError("a stepwise prove / verify gave another "
                                 "result")
        steps["prove"].append(tp.totals())
        steps["verify"].append(tv.totals())
        rounds.append(tp.rounds())
    for fn, runs in steps.items():
        for name in runs[0]:
            per_run = [run[name] for run in runs]
            emit({"phase": "sipp_step_times", "n": n, "function": fn,
                  "step": name, "ms": min(per_run), "runs": per_run,
                  "timing": "host clock around synchronised steps, min of 3"})
    best = min(rounds, key=lambda rs: sum(x["pairings_ms"] for x in rs))
    size = n
    for row in best:
        size //= 2
        row["n"] = size
    emit({"phase": "sipp_round_times", "n": n, "rounds": best,
          "timing": "host clock, the run of 3 with the least pairing time"})
    emit({"phase": "sipp_times", "n": n,
          "prove_ms": min(totals["prove_ms"]),
          "verify_ms": min(totals["verify_ms"]), "runs": totals,
          "timing": "host clock around synchronised calls, min of 3"})


# ---------------------------------------------------------------------------
# TIPP: TIPA over the pairing inner product
# ---------------------------------------------------------------------------

def tipp_srs(ctx, n):
    """The SRS for n from the seed (the same alpha and beta every time)."""
    from ripp_tpu_torch.models import tipa
    from ripp_tpu_torch.utils.fiat_shamir import SeededRng

    return tipa.setup_srs(ctx, SeededRng(SEED), n)


def tipp_shift(ctx):
    """An SRS shift r != 1 from the seed."""
    return random.Random(SEED + 8).randrange(2, ctx.host.r)


def tipp_instance(ctx, A, B, srs, r_shift=1):
    """TIPP on host points A (G1) and B (G2) with the keys of `srs`: with
    a shift r != 1 the messages m_a are scaled by r^i and the keys ck_a by
    r^-i, as an aggregator does (com_a stays as it was: checked); then the
    three commitments."""
    from types import SimpleNamespace

    from ripp_tpu_torch.models.instances import tipp_config
    from ripp_tpu_torch.models.vectors import FrVec, PointVec
    from ripp_tpu_torch.utils.poly import structured_scalar_power

    host = ctx.host
    n = len(A)
    cfg = tipp_config(ctx)
    ck_a, ck_b = srs.get_commitment_keys()
    ck_t = cfg.ipc.setup(None, 1)
    m_a = PointVec.from_host(ctx, "g1", A)
    m_b = PointVec.from_host(ctx, "g2", B)
    com_a = cfg.lmc.commit(ck_a, m_a)
    com_b = cfg.rmc.commit(ck_b, m_b)
    if r_shift != 1:
        r_inv = pow(r_shift, -1, host.r)
        m_a = m_a.hadamard_scale(FrVec.from_ints(
            ctx, structured_scalar_power(n, r_shift, host.r)))
        ck_a = ck_a.hadamard_scale(FrVec.from_ints(
            ctx, structured_scalar_power(n, r_inv, host.r)))
        if cfg.lmc.commit(ck_a, m_a) != com_a:
            raise AssertionError(f"TIPP(n={n}): the SRS shift changed com_a")
    com_t = cfg.ipc.commit(ck_t, [cfg.ip.compute(m_a, m_b)])
    return SimpleNamespace(ctx=ctx, cfg=cfg, srs=srs,
                           v_srs=srs.get_verifier_key(), m_a=m_a, m_b=m_b,
                           ck=(ck_a, ck_b, ck_t), com=(com_a, com_b, com_t),
                           r_shift=r_shift)


def tipp_prove(inst, step=None):
    from ripp_tpu_torch.models import tipa

    kw = {} if step is None else {"step": step}
    return tipa.prove_with_srs_shift(inst.cfg, inst.srs, (inst.m_a, inst.m_b),
                                     inst.ck, inst.r_shift, **kw)


def tipp_verify(inst, proof, com=None, r_shift=None, step=None):
    """verify_with_srs_shift with the PairingCheck's coefficients drawn
    from a seeded generator."""
    from ripp_tpu_torch.models import tipa

    kw = {} if step is None else {"step": step}
    return tipa.verify_with_srs_shift(
        inst.cfg, inst.v_srs, inst.ck[2], com or inst.com, proof,
        inst.r_shift if r_shift is None else r_shift,
        rand=torch.Generator().manual_seed(SEED), **kw)


class ChallengeLog:
    """A `step` of tipa.prove that runs each step and keeps the prover's
    round challenges c, in prove order."""

    def __init__(self):
        self.challenges = []

    def __call__(self, name, fn):
        out = fn()
        if name == "challenge":
            self.challenges.append(out[0])
        return out


def tipp_transcript_check(inst, proof, log):
    """The prover's challenges are the ones the verifier replays."""
    from ripp_tpu_torch.models import gipa

    _, transcript = gipa.compute_recursive_challenges(
        inst.cfg, inst.com, proof.gipa_proof)
    if transcript != list(reversed(log.challenges)):
        raise AssertionError("TIPP: the prover's challenges differ from "
                             "the verifier's")


def tipp_round1_check(inst, proof):
    """Round 1's two commitments (com_a, com_b, com_t) against the host
    model's pairing products on the split vectors (gipa.rs:207-232)."""
    from ripp_tpu_torch.host import pairing as hp

    host = inst.ctx.host
    m_a, m_b = inst.m_a.to_host(), inst.m_b.to_host()
    ck_a, ck_b = inst.ck[0].to_host(), inst.ck[1].to_host()
    h = len(m_a) // 2

    def mp(ps, qs):
        return hp.multi_pairing(host, ps, qs)

    want_1 = (mp(m_a[h:], ck_a[:h]), mp(ck_b[h:], m_b[:h]),
              mp(m_a[h:], m_b[:h]))
    want_2 = (mp(m_a[:h], ck_a[h:]), mp(ck_b[:h], m_b[h:]),
              mp(m_a[:h], m_b[h:]))
    com_1, com_2 = proof.gipa_proof.steps[-1]  # steps are stored reversed
    for got, want in ((com_1, want_1), (com_2, want_2)):
        if (got[0], got[1], got[2].items[0]) != want:
            raise AssertionError("TIPP round 1 commitments != host model")


def tipp_tampered(host, proof):
    """The proof with one GT element changed (squared: still in GT)."""
    from ripp_tpu_torch.models import gipa, tipa

    steps = list(proof.gipa_proof.steps)
    k = len(steps) // 2
    (ca, cb, ct), com_2 = steps[k]
    steps[k] = ((host.tower.fp12.mul(ca, ca), cb, ct), com_2)
    return tipa.TIPAProof(
        gipa_proof=gipa.GIPAProof(steps=steps,
                                  r_base=proof.gipa_proof.r_base),
        final_ck=proof.final_ck, final_ck_proof=proof.final_ck_proof)


def tipp_verdicts(inst, proof):
    """verify on the honest proof, a tampered one, a wrong commitment and
    (when shifted) a wrong shift; raises unless only the honest one
    passes."""
    host = inst.ctx.host
    com_a, com_b, com_t = inst.com
    got = {
        "honest": tipp_verify(inst, proof),
        "tampered": tipp_verify(inst, tipp_tampered(host, proof)),
        "wrong_commitment": tipp_verify(
            inst, proof, com=(com_a, host.tower.fp12.mul(com_b, com_b),
                              com_t)),
    }
    if inst.r_shift != 1:
        got["wrong_shift"] = tipp_verify(inst, proof,
                                         r_shift=inst.r_shift + 1)
    want = {k: k == "honest" for k in got}
    if got != want:
        raise AssertionError(f"TIPP(n={len(inst.m_a)}, shifted="
                             f"{inst.r_shift != 1}) verify: {got}")
    return got


def tipp_checked(ctx, fixtures, n=8):
    """TIPP at n = 8 without and with an SRS shift: round 1 against the
    host model, the prover's challenges against the verifier's, verify's
    verdicts."""
    _, _, A, B, _ = fixtures
    srs = tipp_srs(ctx, n)
    runs = []
    for r_shift in (1, tipp_shift(ctx)):
        inst = tipp_instance(ctx, A[:n], B[:n], srs, r_shift)
        log = ChallengeLog()
        proof = tipp_prove(inst, log)
        tipp_round1_check(inst, proof)
        tipp_transcript_check(inst, proof, log)
        runs.append({"shifted": r_shift != 1,
                     "rounds": len(proof.gipa_proof.steps),
                     "verify": tipp_verdicts(inst, proof)})
    emit({"phase": "tipp_checked", "n": n, "round1_equal_to_host_model": True,
          "prover_challenges_equal_verifier": True, "runs": runs})


def tipp_full(ctx, hctx, fixtures, n):
    """TIPP at n: setup, then prove + verify under cios16 with the launch
    counts set to 0 before and read after; the checks of tipp_checked but
    round 1's, without and with a shift; then the same instance and seed
    under hybrid8 (counted the same way), whose proof must equal the
    cios16 proof byte for byte. Only then the times. Returns the counts
    of the two runs."""
    from ripp_tpu_torch.models import tipa

    _, _, A, B, _ = fixtures
    A, B = A[:n], B[:n]
    setup_ms, srs = host_ms(lambda: tipp_srs(ctx, n))
    inst = tipp_instance(ctx, A, B, srs)
    sync()
    reset_counts()
    log = ChallengeLog()
    proof = tipp_prove(inst, log)
    ok = tipp_verify(inst, proof)
    sync()
    counts = read_counts()
    if not ok:
        raise AssertionError(f"TIPP(n={n}) verify rejected the honest proof")
    tipp_transcript_check(inst, proof, log)
    verdicts = tipp_verdicts(inst, proof)
    shifted = tipp_instance(ctx, A, B, srs, tipp_shift(ctx))
    slog = ChallengeLog()
    sproof = tipp_prove(shifted, slog)
    tipp_transcript_check(shifted, sproof, slog)
    s_verdicts = tipp_verdicts(shifted, sproof)

    h_setup_ms, hsrs = host_ms(lambda: tipp_srs(hctx, n))
    hinst = tipp_instance(hctx, A, B, hsrs)
    if hinst.com != inst.com:
        raise AssertionError(f"TIPP(n={n}): hybrid8 commitments differ")
    sync()
    reset_counts()
    hproof = tipp_prove(hinst)
    h_ok = tipp_verify(hinst, hproof)
    sync()
    h_counts = read_counts()
    proof_bytes = tipa.ser_proof(inst.cfg, proof)
    if tipa.ser_proof(hinst.cfg, hproof) != proof_bytes:
        raise AssertionError(f"TIPP(n={n}): the hybrid8 proof differs from "
                             "the cios16 proof")
    if not h_ok:
        raise AssertionError(f"TIPP(n={n}) hybrid8 verify rejected")
    emit({"phase": "tipp_full_checked", "n": n,
          "rounds": len(proof.gipa_proof.steps),
          "proof_bytes": len(proof_bytes),
          "prover_challenges_equal_verifier": True,
          "verify": verdicts, "verify_shifted": s_verdicts,
          "hybrid8_proof_equal_to_cios16": True, "hybrid8_verify": h_ok,
          "setup_ms": {"cios16": setup_ms, "hybrid8": h_setup_ms},
          "launches": counts, "launches_hybrid8": h_counts})
    tipp_times(inst, hinst, proof_bytes)
    return counts, h_counts


def tipp_times(inst, hinst, proof_bytes):
    """Min of 3 on the host clock of prove and verify, each cios16 run
    with a StepTimer inside (it synchronises around every step: a few
    dozen synchronises against seconds of work), the hybrid8 instance
    `hinst` in turns with it (cios16 first in runs 1 and 3, hybrid8 first
    in run 2); one line a step, the rounds of the run with the least
    commitment time, and the totals."""
    from ripp_tpu_torch.models import tipa

    n = len(inst.m_a)
    totals = {"prove_ms": [], "verify_ms": [], "hybrid8_prove_ms": [],
              "hybrid8_verify_ms": []}
    steps = {"prove": [], "verify": []}
    rounds = []

    def stepped():
        tp, tv = StepTimer(), StepTimer()
        ms, pf = host_ms(lambda: tipp_prove(inst, tp))
        totals["prove_ms"].append(ms)
        ms, ok = host_ms(lambda: tipp_verify(inst, pf, step=tv))
        totals["verify_ms"].append(ms)
        if tipa.ser_proof(inst.cfg, pf) != proof_bytes or not ok:
            raise AssertionError("a timed TIPP prove / verify gave another "
                                 "result")
        steps["prove"].append(tp.totals())
        steps["verify"].append(tv.totals())
        rows = []
        for name, t in tp.events:
            if name == "commitments":
                rows.append({"n": n >> (len(rows) + 1)})
            if name in ("commitments", "challenge", "folds"):
                rows[-1][name + "_ms"] = t
        rounds.append(rows)

    def hybrid8():
        ms, pf = host_ms(lambda: tipp_prove(hinst))
        totals["hybrid8_prove_ms"].append(ms)
        ms, ok = host_ms(lambda: tipp_verify(hinst, pf))
        totals["hybrid8_verify_ms"].append(ms)
        if tipa.ser_proof(hinst.cfg, pf) != proof_bytes or not ok:
            raise AssertionError("a timed hybrid8 TIPP prove / verify gave "
                                 "another result")

    for order in ((stepped, hybrid8), (hybrid8, stepped),
                  (stepped, hybrid8)):
        for run in order:
            run()
    for fn, runs in steps.items():
        for name in runs[0]:
            per_run = [run[name] for run in runs]
            emit({"phase": "tipp_step_times", "n": n, "function": fn,
                  "step": name, "ms": min(per_run), "runs": per_run,
                  "timing": "host clock around synchronised steps, min of 3"})
    best = min(rounds, key=lambda rs: sum(x["commitments_ms"] for x in rs))
    emit({"phase": "tipp_round_times", "n": n, "rounds": best,
          "timing": "host clock, the run of 3 with the least commitment "
                    "time"})
    emit({"phase": "tipp_times", "n": n,
          "prove_ms": min(totals["prove_ms"]),
          "verify_ms": min(totals["verify_ms"]),
          "hybrid8_prove_ms": min(totals["hybrid8_prove_ms"]),
          "hybrid8_verify_ms": min(totals["hybrid8_verify_ms"]),
          "runs": totals,
          "timing": "host clock around synchronised calls, min of 3; "
                    "cios16 with its StepTimer, hybrid8 without one"})


def build_all(ctx, verbose):
    """Both libraries (Fp and Fr), built side by side."""
    from concurrent.futures import ThreadPoolExecutor

    from ripp_tpu_torch.utils import build

    specs = (ctx.t.spec_fp, ctx.t.spec_fr)
    with ThreadPoolExecutor(len(specs)) as ex:
        list(ex.map(lambda sp: build.load_library(sp, verbose=verbose),
                    specs))
    return {build.library_key(sp): build.BUILD_SECONDS[build.library_key(sp)]
            for sp in specs}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at small sizes only")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print what ptxas says about each kernel")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from ripp_tpu_torch.ops import fp_cuda
    from ripp_tpu_torch.ops.pairing import dev_pairing
    from ripp_tpu_torch.ops.points import dev_ctx
    from ripp_tpu_torch.utils import build

    t_start = time.time()
    card = gpu_line()

    # phase 1: build
    ctx = dev_ctx("bls12_381")
    t0 = time.time()
    seconds = build_all(ctx, args.verbose_build)
    emit({"phase": "build", "seconds": seconds,
          "wall_seconds": time.time() - t0, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if args.verbose_build:
        for key in seconds:
            print(build.BUILD_LOG.get(key, ""), flush=True)

    plain_ctx = dev_ctx("bls12_381", plain=True)
    hctx = dev_ctx("bls12_381", fp_kernel="hybrid8")
    dp = dev_pairing(ctx)
    plain_dp = dev_pairing(plain_ctx)

    # fixtures of the full-size runs, made once (host, native C group law)
    sizes = (8,) if args.quick else (256, 2048, 4096)
    sipp_n = 8 if args.quick else 4096
    tipp_n = 8 if args.quick else 1024
    host = ctx.host
    rng = random.Random(SEED + 4)
    n_max = max(max(sizes), sipp_n)
    a = [rng.randrange(1, host.r) for _ in range(n_max)]
    b = [rng.randrange(1, host.r) for _ in range(n_max)]
    r = [rng.randrange(host.r) for _ in range(n_max)]
    t0 = time.time()
    A = host.g1.scalar_mul_batch(host.g1_gen, a)
    B = host.g2.scalar_mul_batch(host.g2_gen, b)
    emit({"phase": "fixtures", "pairs": n_max, "seconds": time.time() - t0})
    fixtures = (a, b, A, B, r)

    # phase 2: kernels, at the shapes the main paths give them
    sipp_sizes = sorted({8, sipp_n})
    tipp_sizes = sorted({8, tipp_n})
    seen = main_path_shapes(ctx, hctx, dp, sizes, fixtures, sipp_sizes,
                            tipp_sizes)
    emit({"phase": "main_path_shapes", "sizes": list(sizes),
          "sipp_sizes": sipp_sizes, "tipp_sizes": tipp_sizes,
          "fp_mul_batches": sorted(seen.fp_mul),
          "fp_mul_hybrid8_batches": sorted(seen.fp_mul_hybrid8),
          "fp_cheap_shapes": sorted(seen.fp_cheap),
          "kexec_batches": sorted(seen.kexec),
          "fused_miller_batches": sorted(seen.miller),
          "fused_ladder_shapes": [
              {"group": g, "batch": bt, "nbits": nb, "shared": sh}
              for g, bt, nb, sh in sorted(seen.ladder)],
          "fused_gtexp_shapes": [
              {"batch": bt, "nbits": nb} for bt, nb in sorted(seen.gtexp)]})
    P_all, Q_all = ctx.g1_to_dev(A), ctx.g2_to_dev(B)
    g1a, g2a = ctx.g1.normalize(P_all), ctx.g2.normalize(Q_all)
    affine = (g1a[0], g1a[1], g2a[0], g2a[1])
    n_rate = 1 << (12 if args.quick else 20)
    rows = [check_mont_mul(ctx, seen.fp_mul, n_rate, fp_cuda.fp_mul,
                           fp_cuda.mont_mul_limbs, "fp_mul",
                           "ripp_tpu/ops/fp_pallas.py:211", SEED),
            # K1' is also held against K1
            check_mont_mul(ctx, seen.fp_mul_hybrid8, n_rate,
                           fp_cuda.fp_mul_hybrid8,
                           fp_cuda.mont_mul_limbs_hybrid8, "fp_mul_hybrid8",
                           "ripp_tpu/ops/fp_pallas.py:123", SEED + 7,
                           also=("k1", fp_cuda.fp_mul)),
            check_fp_cheap(ctx, plain_ctx, seen.fp_cheap),
            check_kexec(ctx, plain_ctx, dp, seen.kexec,
                        64 if args.quick else 1024),
            check_miller(ctx, dp, plain_dp, seen.miller, affine),
            check_ladder(ctx, plain_ctx, "g1", seen.ladder, P_all),
            check_ladder(ctx, plain_ctx, "g2", seen.ladder, Q_all),
            check_gtexp(ctx, plain_dp, dp, seen.gtexp)]
    emit({"phase": "kernels_checked",
          "kernels": [{k: rw[k] for k in ("name", "equal", "ms", "plain_ms")}
                      for rw in rows]})

    # phase 3: main paths, checked against the host model
    main_checked(ctx, dp)
    sipp_checked(ctx, fixtures)
    tipp_checked(ctx, fixtures)

    # phase 4: main paths, full size
    by_path = {"multi_pairing": main_full(ctx, dp, sizes, fixtures),
               "sipp": sipp_full(ctx, fixtures, sipp_n)}
    by_path["tipp"], by_path["tipp_hybrid8"] = tipp_full(
        ctx, hctx, fixtures, tipp_n)
    for rw in rows:
        name = rw["name"]
        rw["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        # this slice's main path: TIPP prove + verify at its full n
        rw["launches"] = by_path[
            "tipp_hybrid8" if name == "fp_mul_hybrid8" else "tipp"][name]
    for p, names in PATH_KERNELS.items():
        for name in names:
            if by_path[p][name] < 1:
                raise AssertionError(
                    f"the {p} path never launched kernel {name}")
    if by_path["tipp_hybrid8"]["fp_mul"] != 0:
        raise AssertionError("the tipp_hybrid8 path launched fp_mul "
                             f"{by_path['tipp_hybrid8']['fp_mul']} times")

    emit({"phase": "done", "seconds": time.time() - t_start,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
