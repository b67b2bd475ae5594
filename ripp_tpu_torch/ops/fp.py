"""Device (PyTorch) prime-field arithmetic on limb tensors.

Representation (the JAX package's, unchanged at every public function):
an Fp element batch is a tensor [..., NL] of 16-bit limbs, little-endian,
always in Montgomery form (value * R mod p with R = 2^(16*NL)) and fully
reduced (< p, limbs < 2^16).

Storage type: torch's uint32 support is thin, so limbs are stored in
int32 (values < 2^16, never negative). The plain ring ops (add/sub/neg)
work in int32: every intermediate is below 2^18. The plain Montgomery
product (ops/fp_cuda.mont_mul_limbs) works in int64, where a product of
two limbs and a column sum of NL of them cannot reach the sign bit.

Dispatch: `DevFp.mul` is the wrapper of the Montgomery-multiply CUDA
kernel (ops/fp_cuda.fp_mul). A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. There is no size threshold and no
fallback. A DevFp built with plain=True always takes the plain versions:
that is how the kernels are held against them on the card.

Multiplier: fp_kernel="cios16" (the default) is the CIOS kernel and its
plain version; "hybrid8" is the hybrid 8x16 kernel (K1') and its plain
version. The JAX package chose between the two for the whole process
(RIPP_FP_PALLAS_KERNEL); here each field object carries its choice, so
two contexts with different multipliers live side by side. The fused
kernels (program executor, Miller loop, ladder, GT exponentiation) use
the CIOS body either way, as in the JAX package.

Counterpart of ripp_tpu/ops/fp.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = 0xFFFF
LIMB_DTYPE = torch.int32
FP_KERNELS = ("cios16", "hybrid8")


def int_to_limbs(v: int, nl: int) -> np.ndarray:
    out = np.zeros((nl,), dtype=np.uint32)
    for i in range(nl):
        out[i] = (v >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def limbs_to_int(limbs) -> int:
    v = 0
    arr = np.asarray(limbs, dtype=np.uint64)
    for i in reversed(range(arr.shape[-1])):
        v = (v << LIMB_BITS) | int(arr[..., i])
    return v


def limbs_tensor(arr, device) -> torch.Tensor:
    """numpy limb array (any integer dtype, values < 2^16) -> int32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)


@dataclass(frozen=True)
class FieldSpec:
    """Static per-modulus constants (hashable)."""

    name: str
    p: int
    nl: int

    @functools.cached_property
    def r(self) -> int:
        return pow(2, LIMB_BITS * self.nl, self.p)

    @functools.cached_property
    def r2(self) -> int:
        return pow(2, 2 * LIMB_BITS * self.nl, self.p)

    @functools.cached_property
    def n0inv(self) -> int:
        # -p^-1 mod 2^16
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.p, self.nl)

    @functools.cached_property
    def one_mont(self) -> np.ndarray:
        return int_to_limbs(self.r % self.p, self.nl)

    # --- host <-> device conversion ----------------------------------------
    def to_mont_limbs(self, ints: Sequence[int]) -> np.ndarray:
        """Host ints -> Montgomery limb array [n, NL] (numpy uint32)."""
        r = self.r
        return np.stack(
            [int_to_limbs((v % self.p) * r % self.p, self.nl) for v in ints]
        )

    def from_mont_limbs(self, arr) -> list:
        """Montgomery limbs [..., NL] (tensor or array) -> canonical host
        ints (list with the leading shape flattened)."""
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        a = np.asarray(arr).astype(np.uint32).reshape(-1, self.nl)
        rinv = pow(self.r, -1, self.p)
        return [limbs_to_int(row) * rinv % self.p for row in a]

    def __hash__(self):
        return hash((self.name, self.p, self.nl))


def make_spec(name: str, p: int) -> FieldSpec:
    # Limb count rounded up to a multiple of 4, as in the JAX package: the
    # two packages share R = 2^(16*nl), and the CUDA kernels repack to
    # nl/2 32-bit words read as 16-byte vectors.
    nl = ((p.bit_length() + LIMB_BITS - 1) // LIMB_BITS + 3) // 4 * 4
    # the ripple ring ops need one headroom bit: a+b < 2^(16 nl)
    assert p.bit_length() < nl * LIMB_BITS, (name, p.bit_length(), nl)
    return FieldSpec(name=name, p=p, nl=nl)


def _ripple(cols, carry=None):
    """One carry pass over per-limb tensors (values with headroom) ->
    (list of 16-bit limbs, carry out). `carry` is the carry into limb 0
    (an int or a tensor)."""
    out = []
    for v in cols:
        if carry is not None:
            v = v + carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return out, carry


def plain_add(spec: FieldSpec, a, b):
    """(a + b) mod p on canonical limb tensors: the sum and the sum minus
    p in two ripples; p is subtracted when the sum carried out or is >= p
    (the cheap-op semantics of ripp_tpu/ops/kexec.py k_add)."""
    a, b = torch.broadcast_tensors(a, b)
    p_limbs = spec.p_limbs
    al, bl = a.unbind(-1), b.unbind(-1)
    s, c1 = _ripple([x + y for x, y in zip(al, bl)])
    d, c2 = _ripple(
        [x + (LIMB_MASK - int(pk)) for x, pk in zip(s, p_limbs)], carry=1
    )
    need = ((c1 > 0) | (c2 > 0)).unsqueeze(-1)
    return torch.where(need, torch.stack(d, -1), torch.stack(s, -1))


def plain_sub(spec: FieldSpec, a, b):
    """(a - b) mod p: a - b with its borrow, p added back on a borrow."""
    a, b = torch.broadcast_tensors(a, b)
    p_limbs = spec.p_limbs
    al, bl = a.unbind(-1), b.unbind(-1)
    d1, c1 = _ripple([x + (LIMB_MASK - y) for x, y in zip(al, bl)], carry=1)
    d2, _ = _ripple([x + int(pk) for x, pk in zip(d1, p_limbs)])
    no_borrow = (c1 > 0).unsqueeze(-1)  # a >= b
    return torch.where(no_borrow, torch.stack(d1, -1), torch.stack(d2, -1))


def plain_neg(spec: FieldSpec, a):
    """(-a) mod p: p - a, with a == 0 passed through."""
    p_limbs = spec.p_limbs
    d, _ = _ripple(
        [(int(pk) + LIMB_MASK) - x for x, pk in zip(a.unbind(-1), p_limbs)],
        carry=1,
    )
    is_zero = (a == 0).all(-1, keepdim=True)
    return torch.where(is_zero, a, torch.stack(d, -1))


class DevFp:
    """Field-ops object on limb tensors of one device; same interface
    shape as the host FieldOps so tower code reads the same on both."""

    degree = 1

    def __init__(self, spec: FieldSpec, device, plain: bool = False,
                 fp_kernel: str = "cios16"):
        if fp_kernel not in FP_KERNELS:
            raise ValueError(f"fp_kernel must be one of {FP_KERNELS}, "
                             f"got {fp_kernel!r}")
        self.spec = spec
        self.p = spec.p
        self.name = spec.name
        self.nl = spec.nl
        self.device = torch.device(device)
        self.plain = plain
        self.fp_kernel = fp_kernel
        self._one_dev = limbs_tensor(spec.one_mont, self.device)
        self._zero_dev = torch.zeros((spec.nl,), dtype=LIMB_DTYPE,
                                     device=self.device)

    def _kernel(self, a) -> bool:
        return a.is_cuda and not self.plain

    # --- constants ----------------------------------------------------------
    def zero(self):
        return self._zero_dev

    def one(self):
        return self._one_dev

    def const(self, v: int):
        """Montgomery-form constant from a host int."""
        return limbs_tensor(
            int_to_limbs((v % self.p) * self.spec.r % self.p, self.nl),
            self.device,
        )

    # --- ring ops -----------------------------------------------------------
    def add(self, a, b):
        if self._kernel(a):
            from . import fp_cuda

            return fp_cuda.fp_cheap(self.spec, "add", a, b)
        return plain_add(self.spec, a, b)

    def sub(self, a, b):
        if self._kernel(a):
            from . import fp_cuda

            return fp_cuda.fp_cheap(self.spec, "sub", a, b)
        return plain_sub(self.spec, a, b)

    def neg(self, a):
        if self._kernel(a):
            from . import fp_cuda

            return fp_cuda.fp_cheap(self.spec, "neg", a, a)
        return plain_neg(self.spec, a)

    def mul(self, a, b):
        """Montgomery product by this field's multiplier: its CUDA kernel
        for CUDA tensors, its plain version for CPU tensors (or always, on
        a plain=True field)."""
        from . import fp_cuda

        if self.fp_kernel == "hybrid8":
            if self._kernel(a):
                return fp_cuda.fp_mul_hybrid8(self.spec, a, b)
            return fp_cuda.mont_mul_limbs_hybrid8(self.spec, a, b)
        if self._kernel(a):
            return fp_cuda.fp_mul(self.spec, a, b)
        return fp_cuda.mont_mul_limbs(self.spec, a, b)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_small(self, a, k: int):
        """Multiply by a small non-negative integer constant (add chain)."""
        if k == 0:
            return self.zero().expand(a.shape)
        acc = a
        for bit in bin(k)[3:]:
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, a)
        return acc

    def mul_int(self, a, n: int):
        n = n % self.p
        if n.bit_length() <= 4:
            return self.mul_small(a, n)
        return self.mul(a, self.const(n))

    def pow(self, a, e: int):
        """a^e for a static python-int exponent: MSB-first square and
        multiply; the exponent's bits are known, so no select is needed."""
        if e < 0:
            return self.pow(self.inv(a), -e)
        if e == 0:
            return self.one().expand(a.shape)
        acc = a
        for bit in bin(e)[3:]:
            acc = self.sqr(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Fermat inversion a^(p-2). Maps 0 -> 0 (callers guard)."""
        return self.pow(a, self.p - 2)

    # --- predicates ---------------------------------------------------------
    def is_zero(self, a):
        return (a == 0).all(-1)

    def eq(self, a, b):
        return (a == b).all(-1)

    def select(self, mask, a, b):
        """mask [...] bool -> elementwise select of limb tensors."""
        return torch.where(mask.unsqueeze(-1), a, b)

    # --- conversions --------------------------------------------------------
    def from_int(self, v: int):
        return self.const(v)

    def tolist(self, a):
        raise NotImplementedError("device elements: use spec.from_mont_limbs")
