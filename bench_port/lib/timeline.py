"""Reductions from spans and device timelines to numbers.

* ``self_times``: the interval-nesting sweep of ``scripts/trace_report.py``
  (copied here, standard library only): a span's self time is its
  duration less the part its children cover; each span also gets its
  ancestors' names.
* ``union``, ``gaps``: the device's busy time as the union of its kernel
  and copy intervals (a sum of per-operator totals counts an operator and
  the kernel it launches twice), and the idle gaps between them.
* ``p95``: the 95th percentile of all samples (linear interpolation
  between order statistics, ``statistics.quantiles`` inclusive).
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]


def self_times(events: Sequence[Dict]) -> List[Dict]:
    """``events``: dicts with ``name``, ``ts`` and ``dur`` (one clock,
    properly nested).  Returns, in the input order, ``{"name", "self",
    "ancestors"}`` per span, ``self`` in the unit of ``dur``."""
    order = sorted(range(len(events)),
                   key=lambda i: (events[i]["ts"], -events[i]["dur"]))
    child = [0.0] * len(events)
    anc: List[Tuple[str, ...]] = [()] * len(events)
    stack: List[int] = []
    eps = 1e-6  # absorbs float noise at shared boundaries
    for i in order:
        ev = events[i]
        while stack and (events[stack[-1]]["ts"]
                         + events[stack[-1]]["dur"]) <= ev["ts"] + eps:
            stack.pop()
        if stack:
            top = stack[-1]
            child[top] += ev["dur"]
            anc[i] = anc[top] + (events[top]["name"],)
        stack.append(i)
    return [{"name": ev["name"], "self": max(0.0, ev["dur"] - child[i]),
             "ancestors": anc[i]} for i, ev in enumerate(events)]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Sequence[Interval], lo: float,
         hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def gaps(busy: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The idle intervals of ``[lo, hi]`` around the disjoint ``busy``."""
    out = []
    t = lo
    for s, e in clip(busy, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def covered(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in union(intervals))


def p95(values: Sequence[float]) -> float:
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]
