"""Declarative SLOs + the watchdog that enforces them in-process.

A rule is data, not code, so the same JSON file drives three
consumers: the ``SloWatchdog`` riding the admission pipeline, the
``scripts/trace_report.py --slo`` CI gate reading a BENCH metrics
block, and an operator eyeballing the file.  Rule kinds map onto what
the registry snapshot exposes:

* ``quantile`` - a bucket-histogram percentile bound:
  ``{"kind": "quantile", "metric": "cluster.router.e2e_seconds",
  "q": 0.99, "max": 0.5}`` fails when the snapshot's ``...p99``
  exceeds ``max``.
* ``rate`` - a counter-over-counter ratio bound (evaluated on deltas
  by the watchdog, on absolutes by the report):
  ``{"kind": "rate", "metric": "cluster.router.shed_prescreen",
  "den": "cluster.router.queries", "max": 0.05}``.
* ``gauge`` - an instantaneous bound on a gauge
  (``cluster.router.queue_depth``, the queue/ticket age gauges).
* ``counter`` - a bound on a counter's movement since the last check
  (watchdog) or its absolute value (report) - e.g. "no more than 0
  shed answers, ever".

``SloWatchdog.check()`` evaluates every rule against the registry,
increments ``cluster.router.slo_breaches`` per breaching rule, and -
wired to a ``FlightRecorder`` - dumps the ring buffer so the traces
*leading up to* the breach are preserved.  ``maybe_check()`` is the
hot-path hook: one clock compare until ``min_interval`` elapses.  The
clock is injectable, so tests fire the watchdog deterministically.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from .flight import FlightRecorder
from .metrics import MetricsRegistry, Number

KINDS = ("quantile", "rate", "gauge", "counter")


@dataclass
class SloRule:
    name: str
    kind: str           # one of KINDS
    metric: str         # registry metric name (histogram base for quantile)
    max: float          # the bound (inclusive: value > max breaches)
    q: float = 0.99     # quantile rules only
    den: str = ""       # rate rules: denominator counter

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"rule {self.name!r}: unknown kind"
                             f" {self.kind!r} (want one of {KINDS})")
        if self.kind == "rate" and not self.den:
            raise ValueError(f"rule {self.name!r}: rate needs 'den'")


@dataclass
class Breach:
    rule: str
    metric: str
    value: float
    bound: float

    def __str__(self) -> str:
        return (f"SLO breach [{self.rule}]: {self.metric}"
                f" = {self.value:.6g} > {self.bound:.6g}")


def load_rules(path: str) -> List[SloRule]:
    """Load rules from JSON: either a list of rule objects or
    ``{"rules": [...]}``."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data["rules"]
    return [SloRule(**r) for r in data]


def _quantile_key(rule: SloRule) -> str:
    return f"{rule.metric}.p{int(round(rule.q * 100))}"


def evaluate(rules: List[SloRule], snap: Dict[str, Number],
             prev: Optional[Dict[str, Number]] = None) -> List[Breach]:
    """Evaluate rules against a flat metrics snapshot.  With ``prev``,
    rate/counter rules look at movement since ``prev`` (the watchdog
    mode); without, at absolute values (the report / CI gate mode).
    Quantile and gauge rules always read the current snapshot - the
    bucket histograms are already time-windowed by reset semantics."""
    breaches: List[Breach] = []
    for rule in rules:
        if rule.kind == "quantile":
            val = snap.get(_quantile_key(rule))
            if val is None:
                continue  # histogram empty / absent: nothing to bound
        elif rule.kind == "gauge":
            val = snap.get(rule.metric)
            if val is None:
                continue
        elif rule.kind == "counter":
            cur = snap.get(rule.metric, 0)
            val = cur - prev.get(rule.metric, 0) if prev is not None \
                else cur
        else:  # rate
            num = snap.get(rule.metric, 0)
            den = snap.get(rule.den, 0)
            if prev is not None:
                num -= prev.get(rule.metric, 0)
                den -= prev.get(rule.den, 0)
            if den <= 0:
                continue  # no traffic in the window: no verdict
            val = num / den
        if val > rule.max:
            breaches.append(Breach(rule.name, rule.metric,
                                   float(val), rule.max))
    return breaches


class SloWatchdog:
    """Evaluates rules against registry deltas on a rate-limited
    clock, counts breaches, and triggers flight-recorder dumps.

    Designed to ride ``ClusterRouter._note_depth`` (already called on
    every submit/poll/collect): ``maybe_check()`` costs one clock read
    + compare until ``min_interval`` elapses.
    """

    def __init__(self, registry: MetricsRegistry,
                 rules: List[SloRule], *,
                 clock=None,
                 min_interval: float = 1.0,
                 flight: Optional[FlightRecorder] = None,
                 dump_path: Optional[str] = None,
                 breach_counter: str = "cluster.router.slo_breaches"):
        self.registry = registry
        self.rules = list(rules)
        self.clock = time.monotonic if clock is None else clock
        self.min_interval = min_interval
        self.flight = flight
        self.dump_path = dump_path
        self._breaches = registry.counter(breach_counter)
        self.last_breaches: List[Breach] = []
        self.checks = 0
        self._last_t: Optional[float] = None
        self._prev_snap: Dict[str, Number] = registry.snapshot()

    def check(self) -> List[Breach]:
        """Evaluate all rules now.  Returns (and stores) the breaches;
        increments the breach counter per breaching rule and dumps the
        flight recorder on any breach."""
        snap = self.registry.snapshot()
        breaches = evaluate(self.rules, snap, prev=self._prev_snap)
        self._prev_snap = snap
        self.checks += 1
        self._last_t = self.clock()
        self.last_breaches = breaches
        if breaches:
            self._breaches.inc(len(breaches))
            if self.flight is not None and self.dump_path:
                self.flight.dump(
                    self.dump_path,
                    reason="slo:" + ",".join(b.rule for b in breaches),
                )
        return breaches

    def maybe_check(self) -> Optional[List[Breach]]:
        """Rate-limited ``check()``: runs only if ``min_interval``
        elapsed since the last one (first call checks immediately).
        Returns None when skipped."""
        now = self.clock()
        if self._last_t is not None and \
                now - self._last_t < self.min_interval:
            return None
        return self.check()
