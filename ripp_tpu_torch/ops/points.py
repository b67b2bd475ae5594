"""Device curve contexts: bind towers + curve group laws + host conversions.

`DevCurveCtx` is the device-side counterpart of host `PairingCurve`: G1 over
DevFp, G2 over device Fp2, with host<->device point conversion (affine
host tuples <-> projective limb pytrees), and the scalar -> bits helpers
that feed the ladders.

Bits are uint8 tensors of 0/1, MSB first: [nbits] for a scalar shared by
the whole batch, [batch..., nbits] for one scalar an element (the JAX
package keeps them in uint32; the values are the same).

Counterpart of ripp_tpu/ops/points.py. Not ported yet: BW6DevCtx.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from .curve import DevSWCurve
from .fp import LIMB_BITS
from .tower import DevTower, dev_tower, resolve_device


class DevCurveCtx:
    def __init__(self, tower: DevTower):
        self.t = tower
        self.host = tower.curve
        self.device = tower.device
        self.plain = tower.plain
        self.fp_kernel = tower.fp_kernel
        c = self.host
        fp, fp2 = tower.fp, tower.fp2

        b3_g1 = fp.const(3 * c.g1.b % c.p)
        self.g1 = DevSWCurve(fp, b3_g1, name=c.name + ".dev.g1")
        b3_g2_host = c.tower.fp2.mul_int(c.g2.b, 3)
        b3_g2 = (fp.const(b3_g2_host[0]), fp.const(b3_g2_host[1]))
        self.g2 = DevSWCurve(fp2, b3_g2, name=c.name + ".dev.g2")

        # the one-launch ladder kernel (ops/curve_fused.py): what
        # scalar_mul_bits runs on the card; a plain context has none
        def _ladder(group):
            def make():
                from .curve_fused import fused_ladder

                return fused_ladder(self, group)

            return make

        if not self.plain:
            self.g1._fused_ladder_factory = _ladder("g1")
            self.g2._fused_ladder_factory = _ladder("g2")

    # --- host -> device -------------------------------------------------------
    def _inf_mask(self, pts):
        return torch.tensor([p is None for p in pts], dtype=torch.bool,
                            device=self.device)

    def g1_to_dev(self, pts: Sequence):
        """List of host affine G1 (or None) -> projective device point batch."""
        xs = [p[0] if p is not None else 0 for p in pts]
        ys = [p[1] if p is not None else 1 for p in pts]
        x = self.t.fp_to_dev(xs)
        y = self.t.fp_to_dev(ys)
        return self.g1.from_affine(x, y, self._inf_mask(pts))

    def g2_to_dev(self, pts: Sequence):
        f2 = self.host.tower.fp2
        xs = [p[0] if p is not None else f2.zero() for p in pts]
        ys = [p[1] if p is not None else f2.one() for p in pts]
        x = self.t.fp2_to_dev(xs)
        y = self.t.fp2_to_dev(ys)
        return self.g2.from_affine(x, y, self._inf_mask(pts))

    # --- device -> host -------------------------------------------------------
    def g1_from_dev(self, P) -> List:
        x, y, inf = self.g1.normalize(P)
        xs = self.t.fp_from_dev(x)
        ys = self.t.fp_from_dev(y)
        infs = inf.reshape(-1).tolist()
        return [None if i else (a, b) for a, b, i in zip(xs, ys, infs)]

    def g2_from_dev(self, P) -> List:
        x, y, inf = self.g2.normalize(P)
        xs = self.t.fp2_from_dev(x)
        ys = self.t.fp2_from_dev(y)
        infs = inf.reshape(-1).tolist()
        return [None if i else (a, b) for a, b, i in zip(xs, ys, infs)]

    # --- scalars ---------------------------------------------------------------
    def scalar_bits(self, k: int, nbits: int) -> torch.Tensor:
        """Host int -> MSB-first bit vector [nbits] (shared-scalar form)."""
        k = int(k)
        return torch.tensor(
            [(k >> (nbits - 1 - i)) & 1 for i in range(nbits)],
            dtype=torch.uint8, device=self.device)

    def scalars_to_bits(self, ks: Sequence[int], nbits: int) -> torch.Tensor:
        """Host ints -> MSB-first bit matrix [n, nbits]."""
        out = np.zeros((len(ks), nbits), dtype=np.uint8)
        for j, k in enumerate(ks):
            k = int(k)
            for i in range(nbits):
                out[j, i] = (k >> (nbits - 1 - i)) & 1
        return torch.from_numpy(out).to(self.device)

    def fr_limbs_to_bits(self, fr_mont, nbits: Optional[int] = None):
        """Fr Montgomery limbs [..., NL] -> MSB-first bits [..., nbits] on
        the device: out of Montgomery form by a product with plain 1 (one
        Montgomery-kernel launch on the card), then every limb's bits."""
        fr = self.t.fr
        nbits = nbits or fr.p.bit_length()
        one_plain = torch.zeros((fr.nl,), dtype=fr_mont.dtype,
                                device=fr_mont.device)
        one_plain[0] = 1
        canon = fr.mul(fr_mont, one_plain)
        return limb_bits(canon, nbits).flip(-1)


def limb_bits(limbs, nbits: int) -> torch.Tensor:
    """16-bit limbs [..., NL] -> their LSB-first bits [..., nbits] (uint8;
    bits beyond the limbs are 0)."""
    shifts = torch.arange(LIMB_BITS, dtype=limbs.dtype, device=limbs.device)
    bits = ((limbs.unsqueeze(-1) >> shifts) & 1).flatten(-2)
    if bits.shape[-1] < nbits:
        bits = torch.nn.functional.pad(bits, (0, nbits - bits.shape[-1]))
    return bits[..., :nbits].to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _dev_ctx(curve_name: str, device: torch.device, plain: bool,
             fp_kernel: str) -> DevCurveCtx:
    return DevCurveCtx(dev_tower(curve_name, device, plain, fp_kernel))


def dev_ctx(curve_name: str, device=None, plain: bool = False,
            fp_kernel: str = "cios16") -> DevCurveCtx:
    """Context for a curve on a device: torch.device("cuda") when `device`
    is None (raises if there is no card); the tests pass device="cpu".
    fp_kernel picks the Montgomery multiplier of every standalone Fp and
    Fr product: "cios16" (the default, K1) or "hybrid8" (K1'), the JAX
    package's RIPP_FP_PALLAS_KERNEL as a context argument; it does not
    change a result. Cached per (curve, device, plain, fp_kernel)."""
    return _dev_ctx(curve_name, resolve_device(device), bool(plain),
                    fp_kernel)
