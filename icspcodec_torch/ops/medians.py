"""The reference's 3-way medians (DC/mode predictors and MV prediction).

median3 is a true median; median3_mv_y replicates the y-component typo of
mvPrediction/ImvPrediction (enc src:2399/2418/2472/2491): the middle
branch compares y1 against *x3* instead of y3.
"""
from __future__ import annotations

import torch


def median3(a, b, c):
    m1 = torch.maximum(b, c)
    m2 = torch.maximum(a, c)
    m3 = torch.maximum(a, b)
    return torch.where((a > b) & (a > c), m1, torch.where((b > a) & (b > c), m2, m3))


def median3_mv_y(y1, y2, y3, x3):
    m1 = torch.maximum(y2, y3)
    m2 = torch.where(y1 > x3, y1, y3)
    m3 = torch.maximum(y1, y2)
    return torch.where((y1 > y2) & (y1 > y3), m1, torch.where((y2 > y1) & (y2 > y3), m2, m3))
