"""Metrics export: Prometheus text exposition + periodic JSONL ship.

The registry's ``snapshot()`` is the in-repo currency (BENCH metrics
blocks, deltas); this module is the edge where those numbers leave the
process:

* ``prometheus_text(registry)`` renders any registry in the Prometheus
  text exposition format (version 0.0.4): dotted names sanitized to
  underscores, ``Counter`` -> ``counter`` with the ``_total`` suffix,
  ``Gauge`` -> ``gauge``, plain ``Histogram`` -> ``summary``
  (``_sum``/``_count``), ``BucketHistogram`` -> ``histogram`` with
  cumulative ``_bucket{le="..."}`` lines up to ``+Inf``.
* ``validate_exposition(text)`` is the strict grammar check tier-6
  gates on: TYPE-before-samples, legal metric names, parseable values,
  cumulative non-decreasing histogram buckets terminated by ``+Inf``
  whose count equals ``_count``.  Returns a list of problems (empty =
  valid) so CI can print every violation, not just the first.
* ``MetricsExporter`` ships periodic JSONL snapshots
  (``{"t": ..., "metrics": {...}}`` per line, append-mode) against an
  injectable clock - ``maybe_ship()`` is safe to call from any hot-ish
  path (one float compare when the interval has not elapsed).
"""
from __future__ import annotations

import json
import re
import time
from typing import Dict, List, Optional, Tuple

from .metrics import (
    BucketHistogram,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{([^}]*)\})?"                     # optional labels
    r" (-?(?:[0-9.eE+-]+|Inf|NaN))$"        # value
)
_LABEL_RE = re.compile(r'^([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"$')


def _sanitize(name: str) -> str:
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not _NAME_RE.match(out):
        out = "_" + out
    return out


def _fmt(v) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def prometheus_text(registry: MetricsRegistry,
                    prefix: str = "") -> str:
    """Render every metric under ``prefix`` as Prometheus text
    exposition (0.0.4).  Deterministic: families sorted by name."""
    lines: List[str] = []
    for name, m in sorted(registry._metrics.items()):
        if prefix and not name.startswith(prefix):
            continue
        base = _sanitize(name)
        if isinstance(m, Counter):
            fam = base + "_total"
            lines.append(f"# TYPE {fam} counter")
            lines.append(f"{fam} {_fmt(m.value)}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base} {_fmt(m.value)}")
        elif isinstance(m, BucketHistogram):
            lines.append(f"# TYPE {base} histogram")
            cum = 0
            for bound, c in zip(m.BOUNDS, m.counts):
                cum += c
                lines.append(
                    f'{base}_bucket{{le="{_fmt(bound)}"}} {cum}'
                )
            lines.append(f'{base}_bucket{{le="+Inf"}} {m.count}')
            lines.append(f"{base}_sum {_fmt(m.sum)}")
            lines.append(f"{base}_count {m.count}")
        elif isinstance(m, Histogram):
            lines.append(f"# TYPE {base} summary")
            lines.append(f"{base}_sum {_fmt(m.sum)}")
            lines.append(f"{base}_count {m.count}")
    return "\n".join(lines) + "\n" if lines else ""


def validate_exposition(text: str) -> List[str]:
    """Strict structural validation of a text exposition.  Returns all
    problems found ([] = valid)."""
    problems: List[str] = []
    typed: Dict[str, str] = {}
    # histogram family -> list of (le, value) in order, _sum/_count seen
    hist: Dict[str, Dict] = {}
    seen_samples: Dict[str, bool] = {}

    def family_of(name: str) -> Tuple[str, str]:
        for suf in ("_bucket", "_sum", "_count", "_total"):
            if name.endswith(suf):
                return name[: -len(suf)], suf
        return name, ""

    for i, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) != 4:
                    problems.append(f"line {i}: malformed TYPE line")
                    continue
                _, _, name, mtype = parts
                if mtype not in ("counter", "gauge", "histogram",
                                 "summary", "untyped"):
                    problems.append(
                        f"line {i}: unknown metric type {mtype!r}")
                if name in typed:
                    problems.append(
                        f"line {i}: duplicate TYPE for {name!r}")
                if seen_samples.get(name):
                    problems.append(
                        f"line {i}: TYPE for {name!r} after samples")
                typed[name] = mtype
                if mtype == "histogram":
                    hist[name] = {"buckets": [], "sum": None,
                                  "count": None}
            elif len(parts) >= 2 and parts[1] == "HELP":
                pass
            else:
                problems.append(f"line {i}: malformed comment line")
            continue
        mt = _SAMPLE_RE.match(line)
        if not mt:
            problems.append(f"line {i}: unparseable sample: {line!r}")
            continue
        name, labels, value = mt.group(1), mt.group(2), mt.group(3)
        try:
            val = float(value.replace("Inf", "inf"))
        except ValueError:
            problems.append(f"line {i}: bad value {value!r}")
            continue
        le = None
        if labels:
            for pair in labels.split(","):
                lm = _LABEL_RE.match(pair)
                if not lm:
                    problems.append(
                        f"line {i}: malformed label {pair!r}")
                elif lm.group(1) == "le":
                    le = lm.group(2)
        fam, suffix = family_of(name)
        # a sample must belong to a declared family (strict mode)
        owner = None
        for cand in (name, fam):
            if cand in typed:
                owner = cand
                break
        if owner is None:
            problems.append(
                f"line {i}: sample {name!r} has no TYPE declaration")
            continue
        seen_samples[owner] = True
        mtype = typed[owner]
        if mtype == "counter":
            if not name.endswith("_total"):
                problems.append(
                    f"line {i}: counter sample {name!r} must end in"
                    " _total")
            if val < 0:
                problems.append(
                    f"line {i}: counter {name!r} is negative")
        if mtype == "histogram" and owner == fam:
            h = hist.setdefault(fam, {"buckets": [], "sum": None,
                                      "count": None})
            if suffix == "_bucket":
                if le is None:
                    problems.append(
                        f"line {i}: histogram bucket without le label")
                else:
                    h["buckets"].append((i, le, val))
            elif suffix == "_sum":
                h["sum"] = val
            elif suffix == "_count":
                h["count"] = val

    for fam, h in hist.items():
        buckets = h["buckets"]
        if not buckets:
            problems.append(f"histogram {fam!r}: no buckets")
            continue
        if buckets[-1][1] != "+Inf":
            problems.append(
                f"histogram {fam!r}: last bucket must be le=\"+Inf\"")
        prev = -1.0
        for i, le, val in buckets:
            if val < prev:
                problems.append(
                    f"line {i}: histogram {fam!r} buckets not"
                    " cumulative (le={le})")
            prev = val
        if h["count"] is None:
            problems.append(f"histogram {fam!r}: missing _count")
        elif buckets[-1][1] == "+Inf" and buckets[-1][2] != h["count"]:
            problems.append(
                f"histogram {fam!r}: +Inf bucket != _count")
        if h["sum"] is None:
            problems.append(f"histogram {fam!r}: missing _sum")
    return problems


class MetricsExporter:
    """Periodic JSONL snapshot shipper.  ``maybe_ship()`` is the
    always-on call site hook: one clock read + compare until the
    interval elapses, then one snapshot appended to ``path``."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 interval: float = 10.0, *,
                 prefix: str = "", clock=None):
        self.registry = registry
        self.path = path
        self.interval = interval
        self.prefix = prefix
        self.clock = time.monotonic if clock is None else clock
        self.ships = 0
        self._last: Optional[float] = None

    def ship(self) -> Dict[str, float]:
        """Append one snapshot line now; returns the snapshot."""
        snap = self.registry.snapshot(self.prefix)
        with open(self.path, "a") as f:
            f.write(json.dumps({"t": self.clock(),
                                "metrics": snap}) + "\n")
        self.ships += 1
        self._last = self.clock()
        return snap

    def maybe_ship(self) -> bool:
        """Ship if the interval elapsed since the last ship (the first
        call ships immediately).  Returns whether it shipped."""
        now = self.clock()
        if self._last is not None and now - self._last < self.interval:
            return False
        self.ship()
        return True
