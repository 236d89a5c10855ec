"""Span tracer: phase-attributed wall time across mine/serve/stream/
cluster, exported as Chrome-trace JSON or JSONL.

The repo's performance questions ("where did the H4 cluster qps go?")
need wall time *attributed*: how much of a routed drain was host
bookkeeping vs kernel launch vs actual device execution vs cache
lookups.  This module is that substrate:

* ``span(name, cat=..., **args)`` - a context manager recording one
  timed region.  ``cat`` is the attribution bucket (``"host"``,
  ``"dispatch"``, ``"device"``, ``"cache"``); ``scripts/trace_report.py``
  sums *self time* (duration minus nested child spans) per bucket, so
  nesting never double-counts.
* ``root_or_span(name, **args)`` - public entry points
  (``ClusterRouter.route``, ``PatternServer.query``,
  ``StreamingBank.observe/refresh``, ``AcceleratedMiner.mine_rs``)
  open a *root* span (``cat="wall"``) carrying a fresh trace id when no
  trace is active, and a plain nested span when one is - so a routed
  query owns one trace id that threads through
  ``ClusterRouter.route -> ClusterHost.call -> PatternServer ->
  kernel dispatch`` via a contextvar, with zero plumbing in signatures.
* ``add_complete(name, cat, start, duration)`` - record an
  already-measured interval (the miner times dispatch vs
  ``torch.cuda.synchronize()`` with its own ``perf_counter`` pairs; the
  tracer must not perturb that measurement).

**Disabled is the default and the fast path**: ``span()`` returns a
shared no-op context manager, nothing is recorded, no clocks are read,
and - property-tested in tests/test_obs.py - results and device
dispatch counts are bit-identical with tracing on, off, or absent.
Tracing only ever *observes*: the one behavioural difference when
fully enabled is extra ``torch.cuda.synchronize()`` fences inside device
spans (needed to split launch from execution time; they change timing,
never results or dispatch counts).

**Sampled mode** (``enable_sampling(rate, ...)``) is the always-on
production middle ground.  A deterministic systematic sampler (an
accumulator, no RNG - reproducible run to run) keeps roughly
``rate`` of root spans with their full child trees; the rest become
*tail* roots: two clock reads and nothing recorded, unless the query
breaches ``latency_threshold`` or a layer flagged it anomalous via
``mark()`` (shed, ``exact=False``, overflow escalation), in which case
the root span is kept with ``tail=True``.  Sampled mode NEVER fences:
``server._fence`` consults ``fencing()`` and records the dispatch half
only, so the async pipeline keeps its overlap - which is why
sampled results stay bit-identical and overhead stays within the <= 5%
budget ``check_bench.py`` gates.  Kept traces are counted
(``obs.sampled_spans`` / ``obs.sampled_traces`` / ``obs.tail_traces``
in the registry passed to ``enable_sampling``) and fed to the optional
``FlightRecorder``.

Export: ``save(path)`` writes Chrome ``traceEvents`` JSON for ``.json``
paths (load in ``chrome://tracing`` / Perfetto) and one-span-per-line
JSONL otherwise; ``scripts/trace_report.py`` reads both.
"""
from __future__ import annotations

import contextvars
import json
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

# attribution buckets trace_report.py understands; "wall" is reserved
# for root spans (their duration IS the denominator of the report)
CATEGORIES = ("host", "dispatch", "device", "cache", "wall")

_current_trace: contextvars.ContextVar[Optional[int]] = \
    contextvars.ContextVar("repro_obs_trace", default=None)


class _NoopSpan:
    """The disabled-tracing fast path: one shared, stateless context
    manager."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_token")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any], new_trace: bool):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        # a root span installs a fresh trace id for everything nested
        self._token = (
            _current_trace.set(tracer._next_trace_id())
            if new_trace else None
        )
        self._t0 = tracer.clock()

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tracer.clock()
        self._tracer._record(
            self.name, self.cat, self._t0, t1 - self._t0, self.args
        )
        if self._token is not None:
            _current_trace.reset(self._token)
        return False


@dataclass
class SamplingConfig:
    """Knobs for sampled tracing.  ``rate`` is the head-sampling
    fraction (deterministic systematic sampler - every ``1/rate``-th
    root keeps its full tree); ``latency_threshold`` (seconds) is the
    tail-keep bound: unsampled roots that run longer are kept anyway
    (root span only, flagged ``tail=True``)."""

    rate: float
    latency_threshold: Optional[float] = None


class _SampledRoot:
    """A root span whose whole child tree is recorded.  Temporarily
    flips ``tracer.enabled`` so nested ``span()`` calls record (the
    serving stack is single-threaded; the flag is restored on exit),
    WITHOUT setting ``_full`` - so ``_fence`` stays async."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_token", "_ev0",
                 "anomaly")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.anomaly: Optional[str] = None
        self._token = _current_trace.set(tracer._next_trace_id())
        self._ev0 = len(tracer.events)
        tracer.enabled = True
        tracer._root = self
        self._t0 = tracer.clock()

    def __enter__(self) -> "_SampledRoot":
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        t1 = tr.clock()
        dur = t1 - self._t0
        args = dict(self.args)
        if self.anomaly:
            args["anomaly"] = self.anomaly
        tr._record(self.name, "wall", self._t0, dur, args)
        spans = tr.events[self._ev0:]
        tr.enabled = tr._full
        tr._root = None
        trace_id = _current_trace.get()
        _current_trace.reset(self._token)
        tr._on_keep(spans, dur, self.name, self.anomaly, "sampled",
                    trace_id)
        return False


class _TailRoot:
    """The unsampled-root path: two clock reads, a trace id so nested
    entry points stay no-ops, and a record only if the root breached
    the latency threshold or was ``mark()``-ed anomalous."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_token", "anomaly")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.anomaly: Optional[str] = None
        self._token = _current_trace.set(tracer._next_trace_id())
        tracer._root = self
        self._t0 = tracer.clock()

    def __enter__(self) -> "_TailRoot":
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        t1 = tr.clock()
        dur = t1 - self._t0
        s = tr.sampling
        thr = s.latency_threshold if s is not None else None
        keep = self.anomaly is not None or (
            thr is not None and dur >= thr
        )
        tr._root = None
        trace_id = _current_trace.get()
        _current_trace.reset(self._token)
        if keep:
            args = dict(self.args)
            args["tail"] = True
            if self.anomaly:
                args["anomaly"] = self.anomaly
            ev0 = len(tr.events)
            # _current_trace is reset already; stamp the id explicitly
            tok = _current_trace.set(trace_id)
            tr._record(self.name, "wall", self._t0, dur, args)
            _current_trace.reset(tok)
            tr._on_keep(tr.events[ev0:], dur, self.name, self.anomaly,
                        "tail", trace_id)
        return False


class Tracer:
    """Event buffer + clock base.  One module-level instance
    (``tracer``) serves the whole process; everything here is plain
    host Python."""

    # runaway guard: a forgotten enabled tracer must not eat the heap
    MAX_EVENTS = 2_000_000

    def __init__(self) -> None:
        self.enabled = False
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self.clock = time.perf_counter  # injectable (tests, replay)
        self._t_base = self.clock()
        self._trace_seq = 0
        # sampled-mode state
        self.sampling: Optional[SamplingConfig] = None
        self._full = False     # True only under enable(): fences on
        self._acc = 0.0        # systematic-sampler accumulator
        self._root = None      # active sampled/tail root (mark target)
        self.metrics = None    # Optional[MetricsRegistry]
        self.flight = None     # Optional[FlightRecorder]

    # ------------------------------------------------------- lifecycle
    def enable(self) -> None:
        """Full tracing: every span recorded, device spans fenced."""
        self.enabled = True
        self._full = True
        self.sampling = None
        if not self.events:
            self._t_base = self.clock()

    def enable_sampling(self, rate: float, *,
                        latency_threshold: Optional[float] = None,
                        metrics=None, flight=None) -> None:
        """Always-on mode: keep ~``rate`` of root-span trees plus every
        tail/anomalous root, never fence.  ``metrics`` (a
        ``MetricsRegistry``) receives the ``obs.*`` keep counters;
        ``flight`` (a ``FlightRecorder``) receives kept traces."""
        self.sampling = SamplingConfig(
            rate=float(rate), latency_threshold=latency_threshold
        )
        self._acc = 0.0
        self.metrics = metrics
        self.flight = flight
        self.enabled = False
        self._full = False
        if not self.events:
            self._t_base = self.clock()

    def disable(self) -> None:
        self.enabled = False
        self._full = False
        self.sampling = None
        self._root = None
        self.metrics = None
        self.flight = None

    def clear(self) -> None:
        self.events = []
        self.dropped = 0
        self._trace_seq = 0
        self._acc = 0.0
        self._t_base = self.clock()

    def _next_trace_id(self) -> int:
        self._trace_seq += 1
        return self._trace_seq

    # ------------------------------------------------------- recording
    def _record(self, name: str, cat: str, t0: float, dur: float,
                args: Dict[str, Any]) -> None:
        if len(self.events) >= self.MAX_EVENTS:
            self.dropped += 1
            return
        ev = {
            "name": name,
            "cat": cat,
            # Chrome-trace convention: microseconds
            "ts": (t0 - self._t_base) * 1e6,
            "dur": dur * 1e6,
            "trace": _current_trace.get(),
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def _on_keep(self, spans: List[Dict[str, Any]], dur: float,
                 name: str, anomaly: Optional[str], kind: str,
                 trace_id: Optional[int]) -> None:
        """A sampled/tail root completed and was kept: count it and
        hand the span tree to the flight recorder.  Runs only on kept
        traces, so a dict lookup per keep is fine."""
        if self.metrics is not None:
            self.metrics.counter("obs.sampled_spans").inc(len(spans))
            self.metrics.counter(
                "obs.sampled_traces" if kind == "sampled"
                else "obs.tail_traces"
            ).inc()
        if self.flight is not None:
            self.flight.record(name, dur, spans, anomaly=anomaly,
                               kind=kind, trace=trace_id)

    def add_complete(self, name: str, cat: str, start: float,
                     duration: float, **args: Any) -> None:
        """Record an interval measured by the caller (``start`` is a
        ``time.perf_counter()`` value, so it nests consistently with
        context-manager spans)."""
        if self.enabled:
            self._record(name, cat, start, duration, args)

    # --------------------------------------------------------- export
    def chrome_events(self) -> List[Dict[str, Any]]:
        out = []
        for ev in self.events:
            args = dict(ev.get("args", {}))
            if ev["trace"] is not None:
                args["trace"] = ev["trace"]
            out.append({
                "name": ev["name"], "cat": ev["cat"], "ph": "X",
                "ts": ev["ts"], "dur": ev["dur"],
                "pid": 0, "tid": 0, "args": args,
            })
        return out

    def save(self, path: str) -> None:
        """Chrome ``traceEvents`` JSON for ``.json`` paths, JSONL (one
        span object per line) otherwise."""
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump({"traceEvents": self.chrome_events(),
                           "displayTimeUnit": "ms"}, f)
        else:
            with open(path, "w") as f:
                for ev in self.events:
                    f.write(json.dumps(ev) + "\n")


tracer = Tracer()


def enabled() -> bool:
    return tracer.enabled


def fencing() -> bool:
    """True only under full tracing (``enable()``): device spans may
    ``torch.cuda.synchronize()`` to split launch from execution.  Sampled mode
    returns False - the fence would serialize the async pipeline, so
    sampled traces record the dispatch half only."""
    return tracer._full


def sampling() -> Optional[SamplingConfig]:
    """The active sampling config, or None (disabled / full mode)."""
    return tracer.sampling


def enable() -> None:
    tracer.enable()


def enable_sampling(rate: float, *,
                    latency_threshold: Optional[float] = None,
                    metrics=None, flight=None) -> None:
    tracer.enable_sampling(rate, latency_threshold=latency_threshold,
                           metrics=metrics, flight=flight)


def disable() -> None:
    tracer.disable()


def mark(reason: str) -> None:
    """Flag the active root span as anomalous (shed, ``exact=False``,
    overflow escalation, ...).  In sampled mode an anomalous root is
    always kept, even unsampled; everywhere else this is a no-op."""
    root = tracer._root
    if root is not None:
        root.anomaly = reason


def clear() -> None:
    tracer.clear()


def save(path: str) -> None:
    tracer.save(path)


def current_trace() -> Optional[int]:
    """The active trace id (None outside any root span)."""
    return _current_trace.get()


def span(name: str, cat: str = "host", **args: Any):
    """A timed region attributed to bucket ``cat``.  No-op (shared
    singleton, no clock read) while tracing is disabled."""
    if not tracer.enabled:
        return _NOOP
    return _Span(tracer, name, cat, args, new_trace=False)


def root_or_span(name: str, **args: Any):
    """Entry-point span: opens a new trace (``cat="wall"``) when none
    is active - per-query / per-wavefront trace ids are minted here -
    and nests as a plain host span inside an existing trace (a routed
    query reaching ``PatternServer.query`` stays in the route's
    trace).  Under sampled mode, a new root draws from the systematic
    sampler: kept roots record their full tree (``_SampledRoot``),
    the rest become cheap ``_TailRoot``s kept only on threshold breach
    or ``mark()``."""
    if tracer.enabled:
        if _current_trace.get() is None:
            return _Span(tracer, name, "wall", args, new_trace=True)
        return _Span(tracer, name, "host", args, new_trace=False)
    s = tracer.sampling
    if s is None or _current_trace.get() is not None:
        return _NOOP
    tracer._acc += s.rate
    if tracer._acc >= 1.0:
        tracer._acc -= 1.0
        return _SampledRoot(tracer, name, args)
    return _TailRoot(tracer, name, args)


def add_complete(name: str, cat: str, start: float, duration: float,
                 **args: Any) -> None:
    tracer.add_complete(name, cat, start, duration, **args)
