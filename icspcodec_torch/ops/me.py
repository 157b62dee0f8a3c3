"""Motion-compensation helpers of the inter codec, in plain torch.

gather_pred is the plain version of kernel E (ops/mc_fused.py): each
(bs x bs) predictor block is read from the padded previous frame at
origin - mv + pad, with the window origin mapped into the padded frame as
jax.lax.dynamic_slice maps it in the JAX package's gather_pred (window_start
below), so the two agree for any MV, a corrupt one included.  mv_diff_field is the
encoder's differential MV field (mvPrediction enc src:2353-2425).
"""
from __future__ import annotations

import torch

from .medians import median3, median3_mv_y


def window_start(start: torch.Tensor, dim: int, bs: int) -> torch.Tensor:
    """A window's start along a padded axis of length dim, as
    jax.lax.dynamic_slice takes it: a negative start counts from the end
    (start + dim), then the start is clamped to [0, dim - bs] so that the
    window lies inside.  An MV of a compliant stream never reaches either
    rule."""
    return torch.where(start < 0, start + dim, start).clamp(0, dim - bs)


def gather_pred(pad: torch.Tensor, mv: torch.Tensor, bs: int) -> torch.Tensor:
    """Per-block predictors: pad (..., PH, PW); mv (..., mbh, mbw, 2) in
    (x, y) order.  Returns (..., mbh, mbw, bs, bs) in pad's dtype."""
    mbh, mbw = mv.shape[-3], mv.shape[-2]
    ph, pw = pad.shape[-2:]
    dev = pad.device
    by = torch.arange(mbh, device=dev) * bs
    bx = torch.arange(mbw, device=dev) * bs
    mv = mv.to(torch.int64)
    ry = window_start(by[:, None] - mv[..., 1] + bs, ph, bs)   # (..., mbh, mbw)
    rx = window_start(bx[None, :] - mv[..., 0] + bs, pw, bs)
    k = torch.arange(bs, device=dev)
    rows = (ry[..., None] + k)[..., :, None]                  # (..., mbh, mbw, bs, 1)
    cols = (rx[..., None] + k)[..., None, :]                  # (..., mbh, mbw, 1, bs)
    lead = pad.shape[:-2]
    flat = pad.reshape((-1, ph * pw))
    idx = (rows * pw + cols).reshape((flat.shape[0], -1))
    return torch.gather(flat, 1, idx).reshape(lead + (mbh, mbw, bs, bs))


def mv_diff_field(mv: torch.Tensor) -> torch.Tensor:
    """Differential MVs of a field (..., mbh, mbw, 2), fully parallel.

    The predictors use the neighbours' reconstructed MVs, which equal the
    original MVs (ImvPrediction adds the identical predictor back), so the
    whole field vectorizes.  Includes the right-edge (l, ul, u) variant and
    the y-median typo."""
    mbh, mbw = mv.shape[-3], mv.shape[-2]
    x, y = mv[..., 0], mv[..., 1]

    def shift(a, dy, dx):
        return torch.roll(a, shifts=(dy, dx), dims=(-2, -1))

    lx, ly = shift(x, 0, 1), shift(y, 0, 1)
    ux, uy = shift(x, 1, 0), shift(y, 1, 0)
    ulx, uly = shift(x, 1, 1), shift(y, 1, 1)
    urx, ury = shift(x, 1, -1), shift(y, 1, -1)

    is_right = torch.arange(mbw, device=mv.device) == mbw - 1
    row0 = (torch.arange(mbh, device=mv.device) == 0)[:, None]
    col0 = (torch.arange(mbw, device=mv.device) == 0)[None, :]
    # interior: right edge -> median(l, ul, u); else median(l, u, ur)
    bx = torch.where(is_right, ulx, ux)
    by_ = torch.where(is_right, uly, uy)
    cx = torch.where(is_right, ux, urx)
    cy = torch.where(is_right, uy, ury)
    px = median3(lx, bx, cx)
    py = median3_mv_y(ly, by_, cy, cx)

    px = torch.where(row0, lx, torch.where(col0, ux, px))
    py = torch.where(row0, ly, torch.where(col0, uy, py))
    px[..., 0, 0] = 8
    py[..., 0, 0] = 8
    return torch.stack([x - px, y - py], dim=-1)
