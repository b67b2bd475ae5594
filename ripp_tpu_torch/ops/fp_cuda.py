"""Batched Montgomery multiplication: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ripp_tpu/ops/fp_pallas.py. `fp_mul` launches
ripp_fp_mul (csrc/fp_mul.cu), which replaces the Pallas kernel
_mul_kernel / _mul_call there; see the note in that source for what
bounds it on the card. `mont_mul_limbs` is the plain version: the CPU
tests use it, and on the card it is what the kernel is held against.
Nothing on the main path calls it when the tensors are on the card.

`fp_mul_hybrid8` launches ripp_fp_mul_hybrid8 from the same library,
which replaces _mul_kernel_hybrid (the reference's
RIPP_FP_PALLAS_KERNEL=hybrid8 variant); its plain version is
`mont_mul_limbs_hybrid8`. A context made with
dev_ctx(..., fp_kernel="hybrid8") sends every standalone product of its
fields there (ops/fp.py DevFp.mul).

`fp_cheap` launches the batched add / sub / neg helpers from the same
library. The JAX package has no kernel for them (XLA fused them); their
plain versions are plain_add / plain_sub / plain_neg in ops/fp.py.
"""

from __future__ import annotations

import torch

from .fp import LIMB_BITS, LIMB_DTYPE, LIMB_MASK, FieldSpec

# Launch counts (plain integers): one is added where a kernel is launched
# and nowhere else.
launches = 0          # ripp_fp_mul
hybrid8_launches = 0  # ripp_fp_mul_hybrid8
cheap_launches = 0    # ripp_fp_cheap (add / sub / neg helpers)

_CHEAP_OPS = {"add": 1, "sub": 2, "neg": 3}


def mont_mul_limbs(spec: FieldSpec, a, b):
    """Plain Montgomery product a*b*R^-1 mod p on [..., NL] limb tensors,
    canonical in and out; int64 arithmetic throughout.

    Schoolbook columns t[i+j] += a[i]*b[j] (a column holds at most NL
    products below 2^32, so it stays below 2^38), then NL reduction
    rounds that each cancel the lowest limb with m*p and push its carry
    up, a carry ripple, and one conditional subtraction of p."""
    a, b = torch.broadcast_tensors(a, b)
    nl = spec.nl
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)
    t = torch.zeros(a.shape[:-1] + (2 * nl + 1,), dtype=torch.int64,
                    device=a.device)
    for i in range(nl):
        t[..., i:i + nl] += a64[..., i:i + 1] * b64
    p64 = torch.from_numpy(spec.p_limbs.astype("int64")).to(a.device)
    n0 = spec.n0inv
    for i in range(nl):
        m = ((t[..., i] & LIMB_MASK) * n0) & LIMB_MASK
        t[..., i:i + nl] += m.unsqueeze(-1) * p64
        t[..., i + 1] += t[..., i] >> LIMB_BITS
    # t[nl:2nl+1] holds U = (a*b + m*p)/R < 2p in redundant limbs
    res = []
    c = None
    for k in range(nl, 2 * nl):
        v = t[..., k] if c is None else t[..., k] + c
        res.append(v & LIMB_MASK)
        c = v >> LIMB_BITS
    top = t[..., 2 * nl] + c  # zero for p with a headroom bit
    diff = []
    c2 = 1
    for k in range(nl):
        w = res[k] + (LIMB_MASK - int(spec.p_limbs[k])) + c2
        diff.append(w & LIMB_MASK)
        c2 = w >> LIMB_BITS
    geq = ((c2 > 0) | (top > 0)).unsqueeze(-1)
    out = torch.where(geq, torch.stack(diff, -1), torch.stack(res, -1))
    return out.to(LIMB_DTYPE)


def mont_mul_limbs_hybrid8(spec: FieldSpec, a, b):
    """Plain Montgomery product by the reference's hybrid 8x16 method
    (ripp_tpu/ops/fp_pallas.py _mul_kernel_hybrid), step by step, in
    int64 (every value stays below 2^31, so it equals the kernel's uint32
    arithmetic); canonical in and out, equal to mont_mul_limbs.

    The 2*NL bytes of a times the NL limbs of b accumulate at byte
    positions i2 + 2j of 4*NL - 2 accumulators; NL reduction rounds take
    m = t16 * (-p^-1) mod 2^16 from the lowest 16-bit group, add its two
    bytes times p at even and odd positions, and shift the cancelled
    group out with its exact carry; then a byte carry ripple and one
    conditional subtraction of p."""
    a, b = torch.broadcast_tensors(a, b)
    nl = spec.nl
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)
    a8 = torch.stack([a64 & 0xFF, a64 >> 8], -1).flatten(-2)  # [..., 2 NL]
    na = 4 * nl - 2
    acc = torch.zeros(a.shape[:-1] + (na,), dtype=torch.int64,
                      device=a.device)
    for i2 in range(2 * nl):
        acc[..., i2:i2 + 2 * nl - 1:2] += a8[..., i2:i2 + 1] * b64
    p16 = torch.from_numpy(spec.p_limbs.astype("int64")).to(a.device)
    n0 = spec.n0inv
    for k in range(nl):
        o = 2 * k
        t16 = (acc[..., o] + ((acc[..., o + 1] & 0xFF) << 8)) & LIMB_MASK
        m16 = (t16 * n0) & LIMB_MASK
        acc[..., o:o + 2 * nl - 1:2] += (m16 & 0xFF).unsqueeze(-1) * p16
        acc[..., o + 1:o + 2 * nl:2] += (m16 >> 8).unsqueeze(-1) * p16
        acc[..., o + 2] += ((acc[..., o] >> 8) + acc[..., o + 1]) >> 8
    # U < 2p in bytes 2 NL .. 4 NL - 3; the carry out of the top is 0
    res8 = []
    c = None
    for k in range(2 * nl):
        idx = 2 * nl + k
        v = acc[..., idx] if idx < na else torch.zeros_like(acc[..., 0])
        if c is not None:
            v = v + c
        res8.append(v & 0xFF)
        c = v >> 8
    res = [res8[2 * k] | (res8[2 * k + 1] << 8) for k in range(nl)]
    diff = []
    borrow = 0
    for k in range(nl):
        w = res[k] + ((1 << LIMB_BITS) - int(spec.p_limbs[k])) - borrow
        diff.append(w & LIMB_MASK)
        borrow = 1 - (w >> LIMB_BITS)
    geq = (borrow == 0).unsqueeze(-1)
    out = torch.where(geq, torch.stack(diff, -1), torch.stack(res, -1))
    return out.to(LIMB_DTYPE)


def check_operand(spec: FieldSpec, x, name: str):
    """What the kernels take: a contiguous int32 CUDA tensor [..., NL]
    whose rows start on 16-byte boundaries."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != LIMB_DTYPE:
        raise TypeError(f"{name}: expected {LIMB_DTYPE}, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] != spec.nl:
        raise ValueError(
            f"{name}: last dimension must be {spec.nl}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer must be 16-byte aligned")


def check_launch(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _binary_launch(spec: FieldSpec, a, b):
    from ..utils.build import load_library

    a, b = torch.broadcast_tensors(a, b)
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    a = a.contiguous()
    b = b.contiguous()
    check_operand(spec, a, "a")
    check_operand(spec, b, "b")
    out = torch.empty_like(a)
    n = a.numel() // spec.nl
    return load_library(spec), a, b, out, n


def fp_mul(spec: FieldSpec, a, b):
    """Batched Montgomery product on the card: a, b int32 [..., NL]
    Montgomery limb tensors (broadcastable); returns the same layout."""
    global launches
    lib, a, b, out, n = _binary_launch(spec, a, b)
    if n == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ripp_fp_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              n, stream)
    check_launch(err, "ripp_fp_mul")
    launches += 1
    return out


def fp_mul_hybrid8(spec: FieldSpec, a, b):
    """The same product by the hybrid 8x16 kernel (K1'): same layout and
    result as fp_mul."""
    global hybrid8_launches
    lib, a, b, out, n = _binary_launch(spec, a, b)
    if n == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ripp_fp_mul_hybrid8(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), n, stream)
    check_launch(err, "ripp_fp_mul_hybrid8")
    hybrid8_launches += 1
    return out


def fp_cheap(spec: FieldSpec, op: str, a, b):
    """Batched add / sub / neg on the card (neg ignores b)."""
    global cheap_launches
    lib, a, b, out, n = _binary_launch(spec, a, b)
    if n == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ripp_fp_cheap(_CHEAP_OPS[op], a.data_ptr(), b.data_ptr(),
                                out.data_ptr(), n, stream)
    check_launch(err, "ripp_fp_cheap")
    cheap_launches += 1
    return out
