"""The benchmark's arithmetic: rates, tails and interval unions.

Plain Python, frozen with the benchmark so that the yardstick does not move
when the program does.  The union of intervals replaces the sum of self
device times that chip_smoke.py's profile_run took: overlapping device
events (copies beside kernels, kernels of several streams) count once.
"""
from __future__ import annotations

import math


def window_rate(units: float, seconds: float) -> float:
    """Work per second over a whole window: all the units completed in it
    over all of its time (no median of chunks, which would hide a stall)."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return units / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linearly interpolated
    between the two nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 50.0)


def union(intervals) -> list[tuple[float, float]]:
    """The disjoint, sorted union of (start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted((float(s), float(e)) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip_to(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of the intervals that lie inside [lo, hi]."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if min(e, hi) > max(s, lo)]


def covered(intervals) -> float:
    """The length that the union of the intervals covers."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union(clip_to(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
