"""The reference's 3-way median (DC and mode predictors)."""
from __future__ import annotations

import torch


def median3(a, b, c):
    m1 = torch.maximum(b, c)
    m2 = torch.maximum(a, c)
    m3 = torch.maximum(a, b)
    return torch.where((a > b) & (a > c), m1, torch.where((b > a) & (b > c), m2, m3))
