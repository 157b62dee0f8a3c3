"""Zig-zag scan as a constant-index gather (zigzagScanning enc src:3014-3096)."""
from __future__ import annotations

import torch

from ..constants import IZIGZAG, ZIGZAG

_ZZ = torch.from_numpy(ZIGZAG.astype("int64"))
_IZZ = torch.from_numpy(IZIGZAG.astype("int64"))


def zigzag(q: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) -> (..., 64) in scan order."""
    return q.reshape(q.shape[:-2] + (64,))[..., _ZZ.to(q.device)]


def izigzag(scan: torch.Tensor) -> torch.Tensor:
    """(..., 64) scan order -> (..., 8, 8)."""
    return scan[..., _IZZ.to(scan.device)].reshape(scan.shape[:-1] + (8, 8))
