"""What the ``open`` kind's readers share: self time of chosen spans of a
traced window (``art.spans``, ``lib/readers.py``) and means of the
router's histograms over it (``art.counters``: the change of their sum and
count, ``kinds/open.py``).  A batch is one flush of the router
(``flush_batch`` + ``flush_deadline`` + ``flush_force``); a query is one
the router admitted (``queries``)."""
from __future__ import annotations

from typing import Optional

FLUSHES = ("flush_batch", "flush_deadline", "flush_force")


def in_trees(roots, name: str, ancestors) -> bool:
    """The span is one of ``roots`` or lies under one of them."""
    return name in roots or any(r in ancestors for r in roots)


def self_us(art, keep) -> Optional[float]:
    """Self time, us, of every span for which ``keep(name, ancestors)``
    holds; None outside an ``open`` window."""
    if art.kind != "open" or not art.ops:
        return None
    return sum(s["self"] for s in art.spans
               if keep(s["name"], s["ancestors"]))


def per(art, total: Optional[float], unit: str) -> Optional[float]:
    """``total`` over the window's batches (``unit="batch"``) or
    admitted queries (``unit="query"``); None where it has none."""
    if total is None:
        return None
    n = (sum(art.counters.get(k, 0) for k in FLUSHES) if unit == "batch"
         else art.counters.get("queries", 0))
    return total / n if n else None


def histogram_mean_ms(art, name: str) -> Optional[float]:
    """Mean of the router histogram ``name`` over the window, ms; None
    outside an ``open`` window or where nothing was observed."""
    if art.kind != "open":
        return None
    key = f"cluster.router.{name}"
    n = art.counters.get(key + ".count", 0)
    return 1e3 * art.counters[key + ".sum"] / n if n else None
