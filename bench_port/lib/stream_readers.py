"""What the ``stream`` kind's span readers share: self time of chosen
spans of a traced window (``art.spans``, ``lib/readers.py``), ms per batch
or per refresh.  A refresh is one ``streaming.refresh`` span; each reader
picks the spans of one subtree under a span the port records in every
window (``streaming.observe`` or ``streaming.refresh``), so spans nested
deeper split the time without moving the reading."""
from __future__ import annotations

from typing import Callable, Optional, Tuple


def self_ms(art, per: str,
            keep: Callable[[str, Tuple[str, ...]], bool]) -> Optional[float]:
    """Self time of every span for which ``keep(name, ancestors)`` holds,
    ms per batch (``per="batch"``) or per refresh (``per="refresh"``);
    None outside a ``stream`` window or where it has none of them."""
    if art.kind != "stream" or not art.ops:
        return None
    n = art.ops if per == "batch" else sum(
        1 for s in art.spans if s["name"] == "streaming.refresh")
    if not n:
        return None
    us = sum(s["self"] for s in art.spans if keep(s["name"], s["ancestors"]))
    return us / 1e3 / n


def in_tree(root: str, name: str, ancestors: Tuple[str, ...]) -> bool:
    """The span is ``root`` or lies under it."""
    return name == root or root in ancestors
