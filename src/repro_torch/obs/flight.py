"""FlightRecorder: a ring buffer of the last N completed query traces.

Production incidents are diagnosed after the fact: by the time a p99
alarm fires, the interesting queries are gone.  The flight recorder
keeps them - every trace the sampler keeps (sampled tree, tail breach,
``mark()``-ed anomaly) lands here as a completed *entry*: the root
name, duration, kind, the span tree, and the registry metric movement
since the previous entry (prefix-scoped, nonzero keys only, so an
entry costs one small snapshot + diff - cheap enough for always-on).

``dump(path)`` writes the buffer as JSONL - one header line (reason,
capacity, entry count, dropped total) then one entry per line, oldest
first - either on demand (an operator asking "what just happened") or
automatically: the ``SloWatchdog`` calls ``dump`` when a rule
breaches, and ``autodump_path`` dumps on the first anomalous entry.

Deterministic by construction: entries carry only what callers pass
plus the injectable ``clock`` reading, so tests drive it with a fake
clock and assert byte-identical dumps.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .metrics import MetricsRegistry


class FlightRecorder:
    """Bounded deque of kept-trace entries + metric deltas.

    ``metrics``/``metrics_prefix`` scope the per-entry delta snapshot
    (e.g. ``"cluster.router"``) - pass a narrow prefix in production;
    an unscoped snapshot of a big registry would eat the overhead
    budget.  ``clock`` defaults to ``time.monotonic`` and is
    injectable for deterministic tests.
    """

    def __init__(self, capacity: int = 64, *,
                 metrics: Optional[MetricsRegistry] = None,
                 metrics_prefix: str = "",
                 clock=None,
                 autodump_path: Optional[str] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.entries: deque = deque(maxlen=capacity)
        self.metrics = metrics
        self.metrics_prefix = metrics_prefix
        self.clock = time.monotonic if clock is None else clock
        self.autodump_path = autodump_path
        self.total = 0       # entries ever recorded (dropped = total - len)
        self.dumps = 0
        self._prev_snap: Dict[str, float] = {}
        if metrics is not None:
            self._prev_snap = metrics.snapshot(metrics_prefix)

    # ------------------------------------------------------- recording
    def record(self, name: str, dur_s: float,
               spans: List[Dict[str, Any]], *,
               anomaly: Optional[str] = None,
               kind: str = "sampled",
               trace: Optional[int] = None) -> None:
        entry: Dict[str, Any] = {
            "t": self.clock(),
            "name": name,
            "dur_s": dur_s,
            "kind": kind,
            "trace": trace,
            "spans": list(spans),
        }
        if anomaly:
            entry["anomaly"] = anomaly
        if self.metrics is not None:
            snap = self.metrics.snapshot(self.metrics_prefix)
            delta = {k: v - self._prev_snap.get(k, 0)
                     for k, v in snap.items()
                     if v != self._prev_snap.get(k, 0)}
            self._prev_snap = snap
            entry["metric_delta"] = delta
        self.entries.append(entry)
        self.total += 1
        if anomaly and self.autodump_path:
            self.dump(self.autodump_path, reason=f"anomaly:{anomaly}")

    # --------------------------------------------------------- export
    def dump(self, path: str, reason: str = "manual") -> int:
        """Write the buffer as JSONL (header line + one entry per
        line, oldest first).  Returns the number of entries written."""
        entries = list(self.entries)
        header = {
            "flight_recorder": True,
            "reason": reason,
            "capacity": self.capacity,
            "entries": len(entries),
            "total_recorded": self.total,
            "dropped": self.total - len(entries),
        }
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for e in entries:
                f.write(json.dumps(e) + "\n")
        self.dumps += 1
        return len(entries)

    def clear(self) -> None:
        self.entries.clear()
        self.total = 0
        if self.metrics is not None:
            self._prev_snap = self.metrics.snapshot(self.metrics_prefix)
