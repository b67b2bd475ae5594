"""Field-program IR: symbolic straight-line programs over a prime field.

Whole algebraic blocks (a Miller doubling step, an addition step) run
inside ONE kernel with every intermediate in the kernel's register file.
Formulas are traced ONCE into this module's program IR (symbolic
registers, ops mul/add/sub/neg/sel/movc), then:

  * schedule() list-schedules the ops into alternating segments of cheap
    ops and GROUPS of independent muls (a dependency level). The grouping
    and its barrier semantics are kept exactly as in the JAX package, so
    that the same program gives the same segments, register numbers and
    constant table in both packages; the CUDA executor (ops/kexec.py,
    csrc/kexec.cuh) runs the ops of a segment in order and needs no
    barrier of its own.
  * register allocation maps SSA values onto a small physical register
    file with free-list reuse.

The same IR runs on a plain PyTorch executor (run_torch) and on Python
ints (run_host) for differential tests.

The tower formulas come from the generic host classes
(ripp_tpu_torch/host/field.py QuadExtOps/CubicExtOps) instantiated over the
symbolic base field: the exact same Karatsuba/CH-SQR3 math as the host
ground truth and the stacked device tower (ops/tower.py).

Counterpart of ripp_tpu/ops/kprog.py (IR and scheduler copied; its
run_xla / run_xla_stacked are run_torch here).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Val:
    """Symbolic SSA value (an Fp element, or a 0/1 mask for 'sel')."""

    idx: int


@dataclass
class Op:
    kind: str          # 'mul' | 'add' | 'sub' | 'neg' | 'sel' | 'movc'
    dst: int
    a: int = -1        # src register / const-table index for movc
    b: int = -1
    m: int = -1        # mask register for 'sel'


class KProg:
    """A straight-line field program under construction."""

    def __init__(self, name: str = "kprog"):
        self.name = name
        self.ops: List[Op] = []
        self.n_vals = 0
        self.inputs: List[int] = []        # val idx per declared input
        self.mask_inputs: List[int] = []   # val idx per declared mask input
        self.consts: List[int] = []        # canonical ints, deduped
        self._const_ids: Dict[int, int] = {}
        self.outputs: List[int] = []

    # --- construction -------------------------------------------------------
    def _new(self) -> Val:
        v = Val(self.n_vals)
        self.n_vals += 1
        return v

    def inp(self) -> Val:
        v = self._new()
        self.inputs.append(v.idx)
        return v

    def mask_inp(self) -> Val:
        """Per-element 0/1 mask input (for 'sel')."""
        v = self._new()
        self.mask_inputs.append(v.idx)
        return v

    def const(self, value: int) -> Val:
        if value in self._const_ids:
            cid = self._const_ids[value]
        else:
            cid = len(self.consts)
            self.consts.append(value)
            self._const_ids[value] = cid
        v = self._new()
        self.ops.append(Op("movc", v.idx, a=cid))
        return v

    def _emit(self, kind: str, a: Val, b: Optional[Val] = None,
              m: Optional[Val] = None) -> Val:
        v = self._new()
        self.ops.append(Op(kind, v.idx, a=a.idx,
                           b=-1 if b is None else b.idx,
                           m=-1 if m is None else m.idx))
        return v

    def mul(self, a: Val, b: Val) -> Val:
        return self._emit("mul", a, b)

    def add(self, a: Val, b: Val) -> Val:
        return self._emit("add", a, b)

    def sub(self, a: Val, b: Val) -> Val:
        return self._emit("sub", a, b)

    def neg(self, a: Val) -> Val:
        return self._emit("neg", a)

    def sel(self, mask: Val, a: Val, b: Val) -> Val:
        """mask ? a : b with a per-element 0/1 mask value."""
        v = self._new()
        self.ops.append(Op("sel", v.idx, a=a.idx, b=b.idx, m=mask.idx))
        return v

    def out(self, vals: Sequence[Val]) -> None:
        self.outputs = [v.idx for v in vals]

    def stats(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for op in self.ops:
            c[op.kind] = c.get(op.kind, 0) + 1
        return c


class ProgFp:
    """FieldOps-shaped symbolic base field recording into a KProg.

    The generic tower classes (host/field.py QuadExtOps, CubicExtOps) and
    the formula-tracing functions below run unmodified over this object; elements
    are Val handles.
    """

    degree = 1

    def __init__(self, prog: KProg, p: int, name: str = "prog_fp"):
        self.prog = prog
        self.p = p
        self.name = name
        self._zero: Optional[Val] = None
        self._one: Optional[Val] = None

    def zero(self) -> Val:
        if self._zero is None:
            self._zero = self.prog.const(0)
        return self._zero

    def one(self) -> Val:
        if self._one is None:
            self._one = self.prog.const(1)
        return self._one

    def const(self, v: int) -> Val:
        return self.prog.const(v % self.p)

    def from_int(self, v: int) -> Val:
        return self.const(v)

    def add(self, a: Val, b: Val) -> Val:
        return self.prog.add(a, b)

    def sub(self, a: Val, b: Val) -> Val:
        return self.prog.sub(a, b)

    def neg(self, a: Val) -> Val:
        return self.prog.neg(a)

    def mul(self, a: Val, b: Val) -> Val:
        return self.prog.mul(a, b)

    def sqr(self, a: Val) -> Val:
        return self.prog.mul(a, a)

    def mul_small(self, a: Val, k: int) -> Val:
        """Multiply by a small non-negative constant via adds (mirrors
        DevFp.mul_small so program outputs match the device path)."""
        if k == 0:
            return self.zero()
        acc = a
        for bit in bin(k)[3:]:
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, a)
        return acc

    def mul_int(self, a: Val, n: int) -> Val:
        n = n % self.p
        if n.bit_length() <= 4:
            return self.mul_small(a, n)
        return self.mul(a, self.const(n))

    def select(self, mask: Val, a: Val, b: Val) -> Val:
        return self.prog.sel(mask, a, b)


def prog_tower(prog: KProg, curve):
    """Symbolic fp/fp2/fp6/fp12 towers for a host PairingCurve, mirroring
    ops/tower.py's non-residue specializations over ProgFp."""
    from ..host.field import CubicExtOps, QuadExtOps

    p = curve.p
    fp = ProgFp(prog, p, name=curve.name + ".prog.fp")
    beta = curve.tower.beta

    if beta == p - 1:
        mul_beta = fp.neg
    else:
        k = (p - beta) % p
        if k < 16:
            mul_beta = lambda a: fp.neg(fp.mul_small(a, k))
        else:
            mul_beta = lambda a: fp.mul(a, fp.const(beta))
    fp2 = QuadExtOps(fp, mul_beta, name=curve.name + ".prog.fp2")

    xi = curve.tower.xi
    if xi == (1, 1):
        def mul_xi(a):
            return (fp.add(a[0], mul_beta(a[1])), fp.add(a[0], a[1]))
    elif xi == (0, 1):
        def mul_xi(a):
            return (mul_beta(a[1]), a[0])
    else:
        xi_c = (fp.const(xi[0]), fp.const(xi[1]))

        def mul_xi(a):
            return fp2.mul(a, xi_c)

    fp6 = CubicExtOps(fp2, mul_xi, name=curve.name + ".prog.fp6")
    fp12 = QuadExtOps(fp6, fp6.mul_by_x, name=curve.name + ".prog.fp12")
    return fp, fp2, fp6, fp12, mul_xi


# ---------------------------------------------------------------------------
# Scheduling: list-schedule into (cheap-op run | independent-mul group)*
# ---------------------------------------------------------------------------

@dataclass
class Scheduled:
    """Program after list scheduling + physical register allocation.

    segments: list of ('ops', [Op...]) with physical indices, or
              ('muls', [(dst, a, b)...]) - an independent group.
    n_regs:   physical register file size.
    inputs/mask_inputs/outputs: physical register indices.
    consts:   canonical ints for the const table.
    """

    name: str
    segments: List[Tuple[str, list]]
    n_regs: int
    inputs: List[int]
    mask_inputs: List[int]
    outputs: List[int]
    consts: List[int]

    def mul_groups(self) -> List[int]:
        return [len(s) for k, s in self.segments if k == "muls"]


def schedule(prog: KProg, max_group: int = 4096,
             pin_inputs: bool = False) -> Scheduled:
    """Greedy list scheduling: repeatedly emit every ready cheap op, then
    one group of all currently-ready muls. Then linear-scan register
    allocation with free-list reuse (mul groups are barriers: a group's
    destination registers never alias any group operand).

    pin_inputs: never reuse input registers (kernels that keep protocol
    state in the input slots across repeated program executions, e.g. the
    fused Miller loop, need them stable even when an input is dead)."""
    ops = prog.ops
    n = len(ops)
    op_of: Dict[int, int] = {}
    for i, op in enumerate(ops):
        op_of[op.dst] = i

    # dependency edges: op i depends on producers of its sources
    deps: List[List[int]] = [[] for _ in range(n)]
    users: List[List[int]] = [[] for _ in range(n)]
    indeg = [0] * n
    for i, op in enumerate(ops):
        srcs = []
        if op.kind != "movc":
            srcs.append(op.a)
            if op.b >= 0:
                srcs.append(op.b)
            if op.m >= 0:
                srcs.append(op.m)
        for s in srcs:
            j = op_of.get(s)
            if j is not None:
                deps[i].append(j)
                users[j].append(i)
                indeg[i] += 1

    ready_cheap = [i for i in range(n) if indeg[i] == 0 and ops[i].kind != "mul"]
    ready_mul = [i for i in range(n) if indeg[i] == 0 and ops[i].kind == "mul"]
    emitted_order: List[Tuple[str, List[int]]] = []
    done = 0
    while done < n:
        run: List[int] = []
        while ready_cheap:
            i = ready_cheap.pop()
            run.append(i)
            done += 1
            for u in users[i]:
                indeg[u] -= 1
                if indeg[u] == 0:
                    (ready_mul if ops[u].kind == "mul" else ready_cheap).append(u)
        if run:
            emitted_order.append(("ops", run))
        if not ready_mul:
            if done < n and not ready_cheap:
                raise AssertionError("cycle in kprog dependency graph")
            continue
        group = ready_mul[:max_group]
        ready_mul = ready_mul[max_group:]
        for i in group:
            done += 1
            for u in users[i]:
                indeg[u] -= 1
                if indeg[u] == 0:
                    (ready_mul if ops[u].kind == "mul" else ready_cheap).append(u)
        emitted_order.append(("muls", group))

    # --- last-use analysis over the emitted order ----------------------------
    seq: List[int] = []
    for _, items in emitted_order:
        seq.extend(items)
    pos_in_seq = {i: k for k, i in enumerate(seq)}
    last_use: Dict[int, int] = {}  # val idx -> seq position of last read
    for i, op in enumerate(ops):
        k = pos_in_seq[i]
        if op.kind != "movc":
            for s in (op.a, op.b, op.m):
                if s >= 0:
                    last_use[s] = max(last_use.get(s, -1), k)
    for v in prog.outputs:
        last_use[v] = n + 1  # outputs live to the end
    for v in prog.inputs + prog.mask_inputs:
        last_use.setdefault(v, -1)

    # --- linear-scan allocation ----------------------------------------------
    phys: Dict[int, int] = {}
    free: List[int] = []
    released = set()
    n_regs = 0
    out_set = set(prog.outputs)

    def alloc(v: int, banned: set) -> int:
        nonlocal n_regs
        for fi, r in enumerate(free):
            if r not in banned:
                free.pop(fi)
                phys[v] = r
                return r
        r = n_regs
        n_regs += 1
        phys[v] = r
        return r

    pinned = set(prog.inputs + prog.mask_inputs) if pin_inputs else set()

    def release(v: int, at: int):
        if v in released or v in out_set or v in pinned:
            return
        if last_use.get(v, -1) <= at:
            r = phys.get(v)
            if r is not None:
                released.add(v)
                free.append(r)

    for v in prog.inputs + prog.mask_inputs:
        alloc(v, set())

    segments: List[Tuple[str, list]] = []
    seqpos = 0
    for kind, items in emitted_order:
        if kind == "ops":
            out_ops: List[Op] = []
            for i in items:
                op = ops[i]
                srcs = [s for s in (op.a, op.b, op.m) if s >= 0]
                if op.kind == "movc":
                    pd = alloc(op.dst, set())
                    out_ops.append(Op("movc", pd, a=op.a))
                else:
                    pa = phys[op.a]
                    pb = phys[op.b] if op.b >= 0 else -1
                    pm = phys[op.m] if op.m >= 0 else -1
                    # release sources whose last use is this op, THEN alloc
                    # dst (safe in-place for elementwise cheap ops is fine:
                    # executors compute the full result before writing)
                    for s in srcs:
                        release(s, seqpos)
                    pd = alloc(op.dst, set())
                    out_ops.append(Op(op.kind, pd, a=pa, b=pb, m=pm))
                seqpos += 1
            segments.append(("ops", out_ops))
        else:
            # barrier semantics: collect operand regs first; dsts must not
            # alias ANY operand of the group (the in-kernel loop runs the
            # group sequentially).
            group_src_regs = set()
            for i in items:
                op = ops[i]
                group_src_regs.add(phys[op.a])
                group_src_regs.add(phys[op.b])
            triples = []
            for i in items:
                op = ops[i]
                pa, pb = phys[op.a], phys[op.b]
                pd = alloc(op.dst, group_src_regs)
                triples.append((pd, pa, pb))
            # releases happen after the whole group
            for i in items:
                op = ops[i]
                release(op.a, seqpos + len(items) - 1)
                release(op.b, seqpos + len(items) - 1)
            seqpos += len(items)
            segments.append(("muls", triples))

    return Scheduled(
        name=prog.name,
        segments=segments,
        n_regs=n_regs,
        inputs=[phys[v] for v in prog.inputs],
        mask_inputs=[phys[v] for v in prog.mask_inputs],
        outputs=[phys[v] for v in prog.outputs],
        consts=list(prog.consts),
    )


# ---------------------------------------------------------------------------
# Reference executors (Python ints; plain PyTorch)
# ---------------------------------------------------------------------------

def run_host(sched: Scheduled, p: int, inputs, masks=()):
    """Execute a scheduled program over python ints mod p (exact ground
    truth, no device involvement). inputs: list of ints (or lists of
    ints for a batch) per input register; masks likewise 0/1.
    Returns the list of output values."""
    def as_list(v):
        return v if isinstance(v, list) else [v]

    batch = max(len(as_list(v)) for v in inputs) if inputs else 1
    regs: Dict[int, list] = {}
    for r, v in zip(sched.inputs, inputs):
        vl = as_list(v)
        regs[r] = vl * batch if len(vl) == 1 else list(vl)
    for r, m in zip(sched.mask_inputs, masks):
        ml = as_list(m)
        regs[r] = ml * batch if len(ml) == 1 else list(ml)
    for kind, items in sched.segments:
        if kind == "muls":
            for d, a, b in items:
                regs[d] = [(x * y) % p for x, y in zip(regs[a], regs[b])]
            continue
        for op in items:
            if op.kind == "movc":
                regs[op.dst] = [sched.consts[op.a] % p] * batch
            elif op.kind == "add":
                regs[op.dst] = [(x + y) % p
                                for x, y in zip(regs[op.a], regs[op.b])]
            elif op.kind == "sub":
                regs[op.dst] = [(x - y) % p
                                for x, y in zip(regs[op.a], regs[op.b])]
            elif op.kind == "neg":
                regs[op.dst] = [(-x) % p for x in regs[op.a]]
            elif op.kind == "sel":
                regs[op.dst] = [a if m else b for m, a, b in
                                zip(regs[op.m], regs[op.a], regs[op.b])]
            else:
                raise ValueError(op.kind)
    return [regs[r] for r in sched.outputs]


def run_torch(sched: Scheduled, fp, inputs, masks=()):
    """Execute a scheduled program with DevFp ops on [batch, NL] tensors.

    fp: ops.fp.DevFp for the program's field. masks: list of bool [batch]
    tensors for mask inputs. Returns the list of output tensors.
    """
    import torch

    regs: Dict[int, object] = {}
    for r, x in zip(sched.inputs, inputs):
        regs[r] = x
    for r, mk in zip(sched.mask_inputs, masks):
        regs[r] = mk
    const_limbs = [fp.const(c) for c in sched.consts]
    for kind, items in sched.segments:
        if kind == "muls":
            for d, a, b in items:
                regs[d] = fp.mul(regs[a], regs[b])
            continue
        for op in items:
            if op.kind == "movc":
                regs[op.dst] = const_limbs[op.a]
            elif op.kind == "add":
                regs[op.dst] = fp.add(regs[op.a], regs[op.b])
            elif op.kind == "sub":
                regs[op.dst] = fp.sub(regs[op.a], regs[op.b])
            elif op.kind == "neg":
                regs[op.dst] = fp.neg(regs[op.a])
            elif op.kind == "sel":
                m = regs[op.m]
                if m.dtype != torch.bool:
                    # a field element used as a mask: its limb 0 is read
                    m = m[..., 0] > 0
                regs[op.dst] = torch.where(
                    m.unsqueeze(-1), regs[op.a], regs[op.b])
            else:
                raise ValueError(op.kind)
    return [regs[r] for r in sched.outputs]
