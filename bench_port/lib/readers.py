"""What the per-layer metric files share.  Each reader gets ``art``, the
traced run's artifacts (``driver.run``):

* ``kind``: the mix's kind (``mine`` or ``query``); ``ops``: the jobs or
  batches of the traced window; ``counters``: the counters' change over
  that window; ``spans``: its spans, each with its self time in
  microseconds and its ancestors' names (``timeline.self_times``);
* ``slice``: the profiled slice after the window, or None where nothing
  was profiled (no card): ``ops``, ``wall_s``, ``busy_s``, ``device``
  (``(name, category, ts us, dur us)`` per kernel and copy);
* ``calls``: each kernel's recorded inputs over the slice; ``roofline``:
  kernel name -> roofline module; ``peaks``: the card's peaks.

A reader returns None when its cell has nothing for it to read.
"""
from __future__ import annotations

from typing import Iterable, Optional


def span_self_ms_per_op(art, names: Iterable[str] = (),
                        under: Iterable[str] = (),
                        exclude: Iterable[str] = ()) -> Optional[float]:
    """Self time, ms per op, of the spans named in ``names`` and of every
    span with an ancestor in ``under``, except those in ``exclude``
    (or under them)."""
    if art.kind != "query" or not art.ops:
        return None
    names, under, exclude = set(names), set(under), set(exclude)
    us = 0.0
    for s in art.spans:
        if s["name"] in exclude or exclude.intersection(s["ancestors"]):
            continue
        if s["name"] in names or under.intersection(s["ancestors"]):
            us += s["self"]
    return us / 1e3 / art.ops


def roofline_share(art, kernel: str) -> Optional[float]:
    """100 x the kernel's least time over the slice (each launch's bytes
    at the HBM peak or its int32 operations at the int32 peak, whichever
    is longer) / its measured time there (the profiler's kernel events).
    None when the slice has no launch of it, or when the recorded calls
    and the kernel events do not pair up."""
    if art.slice is None:
        return None
    mod = art.roofline[kernel]
    calls = [a for a in art.calls.get(kernel, []) if mod.launched(*a)]
    times = [d for name, cat, _, d in art.slice.device
             if cat == "kernel" and mod.KERNEL in name]
    if not calls or len(calls) != len(times):
        return None
    hbm = art.peaks["hbm_bytes_per_s"]
    ops = art.peaks["int32_ops_per_s"]
    bound_s = 0.0
    for a in calls:
        nbytes, nops = mod.counts(*a)
        bound_s += max(nbytes / hbm, nops / ops)
    return 100.0 * bound_s / (sum(times) / 1e6)


def device_idle(art, kind: str) -> Optional[float]:
    if art.kind != kind or art.slice is None or art.slice.wall_s <= 0:
        return None
    return 100.0 * (1.0 - art.slice.busy_s / art.slice.wall_s)
