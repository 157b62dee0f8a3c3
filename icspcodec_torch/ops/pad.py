"""Replicate padding with the reference's off-by-one quirk.

getPaddingImage (enc src:2227-2269) pads `padlen` rows/cols of edge
replication on top/left but only `padlen-1` on bottom/right, leaving the
final padded row and column zero.  Motion vectors at extreme offsets read
those zeros, so the quirk is load-bearing for bit-exactness.
"""
from __future__ import annotations

import torch


def pad_image(img: torch.Tensor, padlen: int) -> torch.Tensor:
    """img: (..., H, W) -> (..., H+2p, W+2p), same dtype."""
    p = padlen
    h, w = img.shape[-2:]
    rows = torch.arange(-p, h + p, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-p, w + p, device=img.device).clamp(0, w - 1)
    out = img[..., rows[:, None], cols[None, :]]
    out[..., -1, :] = 0
    out[..., :, -1] = 0
    return out
