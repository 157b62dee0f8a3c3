"""Scalar quantization with the reference's two rounding regimes.

luma:   q = (int)(v + 0.5) / Qstep      -- truncation toward zero, then C
        integer division (Quantization_block enc src:2780)
chroma: q = (int)floor(v + 0.5) / Qstep -- floor first (CQuantization_block
        enc src:4642); the two differ for negative half-open intervals.

torch's `//` floors; C division truncates, hence rounding_mode="trunc".
"""
from __future__ import annotations

import torch


def c_trunc(x: torch.Tensor) -> torch.Tensor:
    """(int) cast of a floating value: truncation toward zero."""
    return torch.trunc(x).to(torch.int32)


def c_div(a: torch.Tensor, q) -> torch.Tensor:
    """C integer division: truncates toward zero."""
    return torch.div(a.to(torch.int32), q, rounding_mode="trunc")


def quant_block(dct: torch.Tensor, qdc, qac, chroma: bool) -> torch.Tensor:
    """Quantize (..., 8, 8) DCT blocks (DC at [0,0] uses qdc)."""
    half = dct + 0.5
    t = torch.floor(half).to(torch.int32) if chroma else c_trunc(half)
    q = c_div(t, qac)
    q[..., 0, 0] = c_div(t[..., 0, 0], qdc)
    return q


def dequant_block(q: torch.Tensor, qdc, qac) -> torch.Tensor:
    iq = (q * qac).to(torch.int32)
    iq[..., 0, 0] = q[..., 0, 0] * qdc
    return iq


def ac_flag(q: torch.Tensor) -> torch.Tensor:
    """1 iff all 63 AC coefficients of the (..., 8, 8) block are zero."""
    flat = q.reshape(q.shape[:-2] + (64,))
    return ac_flag_from_scan(flat)


def ac_flag_from_scan(scan: torch.Tensor) -> torch.Tensor:
    """Same flag from (..., 64) coefficients whose entry 0 is the DC (block
    order and zig-zag order both start with it)."""
    return (torch.count_nonzero(scan[..., 1:], dim=-1) == 0).to(torch.int32)
