"""Generic log-depth reduction over element pytrees.

scan_reduce keeps the JAX package's shift-and-combine order (a roll by
1, 2, 4, ... with a validity mask), so both packages multiply the same
operands at every step. Work is n*log2(n) combines; each step is one
batched combine over the whole [n, ...] tree.

Counterpart of ripp_tpu/ops/reduce.py (scan_prefix / scan_suffix are not
ported yet).
"""

from __future__ import annotations

import torch

from .tower import tree_leaves, tree_map, tree_select


def _shifts(n: int):
    steps = max(1, (n - 1).bit_length())
    return [1 << s for s in range(steps)]


def axis0_mask(mask, vals):
    """A mask over axis 0 ([n] bool) shaped to select between limb trees
    whose leaves are [n, *batch, NL] (tree_select appends the limb axis)."""
    leaf = tree_leaves(vals)[0]
    return mask.reshape((mask.shape[0],) + (1,) * (leaf.dim() - 2))


def scan_reduce(combine, vals, n: int):
    """Combine all n elements along axis 0 -> tree with axis 0 removed.
    Leaves may carry batch axes after axis 0 ([n, *batch, NL]): each
    batch lane is reduced on its own."""
    if n == 1:
        return tree_map(lambda x: x[0], vals)
    idx = torch.arange(n, device=tree_leaves(vals)[0].device)
    for shift in _shifts(n):
        shifted = tree_map(lambda x: torch.roll(x, -shift, dims=0), vals)
        combined = combine(vals, shifted)
        vals = tree_select(axis0_mask((idx + shift) < n, vals), combined,
                           vals)
    return tree_map(lambda x: x[0], vals)
