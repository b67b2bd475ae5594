"""State carried between the JAX package and the port.

Both packages keep an Fp batch as [..., NL] 16-bit limbs in Montgomery
form with the same R, and Fp2/Fp12/points as nested tuples of such
arrays. The JAX package holds them in uint32 arrays, the port in int32
tensors. `from_reference` takes a reference value as numpy (a uint32
array, a bool mask, or a nested tuple of them) to the port's tensors on a
device; `to_reference` goes back to numpy uint32 (bool stays bool). The
tests feed both packages the same limbs through these and compare limb for
limb. numpy only: nothing of either package's device runtime is imported.

Protocol vectors cross the same way: `vec_from_reference` takes a
reference FrVec / PointVec (read through its `arr` / `pts`, `n` and `grp`
attributes) to the port's, `vec_to_reference` gives a port vector's limbs
as numpy. GT values need no conversion: both packages hand them to the
host as the same nested tuples of Python ints.
"""

from __future__ import annotations

import numpy as np
import torch


def from_reference(tree, device):
    """numpy uint32 [..., NL] array / bool mask / nested tuple of them ->
    the port's tensors (int32 limbs, bool masks) on `device`."""
    if isinstance(tree, (tuple, list)):
        return tuple(from_reference(t, device) for t in tree)
    arr = np.asarray(tree)
    if arr.dtype == np.bool_:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    if arr.size and int(arr.max()) >= 1 << 16:
        raise ValueError("limb out of range: not a 16-bit limb array")
    return torch.from_numpy(
        np.ascontiguousarray(arr).astype(np.int32)).to(device)


def to_reference(tree):
    """The port's tensors (or a nested tuple of them) -> numpy uint32
    arrays (bool masks stay bool)."""
    if isinstance(tree, (tuple, list)):
        return tuple(to_reference(t) for t in tree)
    arr = tree.detach().cpu().numpy()
    if arr.dtype == np.bool_:
        return arr
    return arr.astype(np.uint32)


def vec_from_reference(ctx, vec):
    """A reference FrVec or PointVec -> the port's, on ctx's device."""
    from ..models.vectors import FrVec, PointVec

    if hasattr(vec, "grp"):
        pts = from_reference(vec.pts, ctx.device)
        return PointVec(ctx, vec.grp, pts, vec.n)
    return FrVec(ctx, from_reference(vec.arr, ctx.device), vec.n)


def vec_to_reference(vec):
    """A port FrVec / PointVec -> its limbs as numpy (a uint32 array or a
    nested tuple of them)."""
    return to_reference(vec.pts if hasattr(vec, "grp") else vec.arr)
