"""The GIPA instantiation matrix as config factories: the TIPP row.

| protocol    | IP        | LMC          | RMC          | IPC            |
|-------------|-----------|--------------|--------------|----------------|
| TIPP        | pairing   | AFGHO G1     | AFGHO G2     | Identity (GT)  |

TIPP keeps its LMC keys in G2 and its RMC keys in G1: the structured
SRS's h^beta / g^alpha even powers, the reference's trait bound
(tipa/mod.rs:130-148).

Counterpart of ripp_tpu/models/instances.py. Not ported yet: the MIPP,
scalar and SSM rows.
"""

from __future__ import annotations

from ..ops.points import DevCurveCtx
from .commitments import (
    AFGHOCommitmentG1,
    AFGHOCommitmentG2,
    IdentityCommitment,
    PairingIP,
)
from .gipa import GIPAConfig


def tipp_config(ctx: DevCurveCtx) -> GIPAConfig:
    return GIPAConfig(
        name="tipp",
        ctx=ctx,
        ip=PairingIP(ctx),
        lmc=AFGHOCommitmentG1(ctx),
        rmc=AFGHOCommitmentG2(ctx),
        ipc=IdentityCommitment(ctx, "gt"),
    )
