"""Zig-zag scan as a constant-index gather (zigzagScanning enc src:3014-3096)."""
from __future__ import annotations

import functools

import torch

from ..constants import IZIGZAG, ZIGZAG


@functools.lru_cache(maxsize=None)
def _order(inverse: bool, device: torch.device) -> torch.Tensor:
    """The scan order (or its inverse) as an index tensor on the device,
    copied there once."""
    return torch.from_numpy((IZIGZAG if inverse else ZIGZAG).astype("int64")).to(device)


def zigzag(q: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) -> (..., 64) in scan order."""
    return q.reshape(q.shape[:-2] + (64,))[..., _order(False, q.device)]


def izigzag(scan: torch.Tensor) -> torch.Tensor:
    """(..., 64) scan order -> (..., 8, 8)."""
    return scan[..., _order(True, scan.device)].reshape(scan.shape[:-1] + (8, 8))
