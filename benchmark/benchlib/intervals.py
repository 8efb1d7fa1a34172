"""Interval arithmetic for device traces: the union of kernel intervals
(streams that overlap are counted once) and the idle gaps between them."""

from __future__ import annotations


def union(intervals) -> list:
    """Merged, sorted ``[(start, end), ...]`` of possibly overlapping
    intervals; empty ones are dropped."""
    merged = []
    for s, e in sorted((s, e) for s, e in intervals if e > s):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def covered(intervals, lo=None, hi=None) -> float:
    """Length of the union of ``intervals``, clipped to ``[lo, hi]``."""
    total = 0.0
    for s, e in union(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e > s:
            total += e - s
    return total


def gaps(intervals, lo, hi) -> list:
    """``[(start, end), ...]`` of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out
