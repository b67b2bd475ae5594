"""Fixed-base windowed multiplication: one base point times many scalars
via a table of its multiples.

Replaces the per-element full-width double-and-add ladder for SRS
generation (reference capability: ark-ec FixedBase::get_window_table /
windowed_mul, consumed at tipa/mod.rs:385-390).

Shape (the JAX package's, in plain PyTorch on the DevSWCurve group law):
  * table build: window_bits doublings per window base (n_windows bases in
    turn, batch 1), then 2^window_bits batch-[n_windows] adds that walk
    the digit multiples;
  * evaluation: one batch-n complete add per window, each gathering the
    digit'd table row for all n outputs. Total point work: W =
    ceil(nbits / window_bits) batch-n adds, against ~2 * nbits ladder
    steps.

Scalars are host ints (SRS powers are made on the host), so the digit
matrix is built in numpy.

Counterpart of ripp_tpu/ops/fixed_base.py (no Pallas kernel there: the
group law's products are the Montgomery kernel's launches on the card).
The batch is evaluated whole (the JAX package chunked it to a few shapes
for XLA).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .curve import DevSWCurve
from .tower import tree_leaves, tree_map


def build_table(curve: DevSWCurve, base, window_bits: int, n_windows: int):
    """base: projective point tree with NO batch dim.
    Returns a table tree [n_windows, 2^window_bits, ...] with
    table[w, d] = d * 2^(window_bits*w) * base."""
    K = 1 << window_bits
    bases = []
    b = tree_map(lambda x: x[None], base)
    for _ in range(n_windows):
        bases.append(b)
        for _ in range(window_bits):
            b = curve.double(b)
    bases = tree_map(lambda *xs: torch.cat(xs), *bases)  # [W, ...]
    mults = []
    t = curve.identity_like(bases[0])
    for _ in range(K):
        mults.append(t)
        t = curve.add(t, bases)
    # mults[d][w] = d * bases[w] -> [W, K, ...]
    return tree_map(lambda *xs: torch.stack(xs, dim=1), *mults)


def eval_table(curve: DevSWCurve, table, digits: torch.Tensor):
    """table: tree [W, K, ...]; digits: int64 [n, W] (LSB-first windows).
    Returns a projective point batch [n] with out_i = sum_w
    table[w, d_iw]."""
    n, W = digits.shape
    first_x = tree_map(lambda x: x[0, 0], table[0])
    acc = curve.identity_like(
        tree_map(lambda x: x.new_zeros((n,) + x.shape), first_x))
    for w in range(W):
        sel = tree_map(lambda x: x[w].index_select(0, digits[:, w]), table)
        acc = curve.add(acc, sel)
    return acc


def scalars_to_digit_matrix(scalars: Sequence[int], window_bits: int,
                            nbits: int) -> np.ndarray:
    """Host ints -> [n, W] digit matrix, LSB-first windows."""
    W = (nbits + window_bits - 1) // window_bits
    mask = (1 << window_bits) - 1
    out = np.zeros((len(scalars), W), dtype=np.int64)
    for i, s in enumerate(scalars):
        s = int(s)
        for w in range(W):
            out[i, w] = (s >> (w * window_bits)) & mask
    return out


def fixed_base_msm(curve: DevSWCurve, base, scalars: Sequence[int],
                   nbits: int, window_bits: int = 8):
    """base: projective tree, batch [1]; scalars: host ints.
    Returns a projective device batch [n] of scalars[i] * base."""
    W = (nbits + window_bits - 1) // window_bits
    base_single = tree_map(lambda x: x[0], base)
    table = build_table(curve, base_single, window_bits, W)
    digits = torch.from_numpy(
        scalars_to_digit_matrix(scalars, window_bits, nbits)).to(
            tree_leaves(table)[0].device)
    return eval_table(curve, table, digits)
