"""MetricsRegistry: the one namespaced home for every runtime counter.

Before this module each subsystem grew its own ad-hoc ``stats`` dict
(``PatternServer.stats``, ``ClusterRouter.stats``,
``StreamingBank.stats``) or bare attributes (the wavefront miner's
``n_device_calls`` / ``device_seconds``), with no shared snapshot,
delta, or reset story - and inconsistent survival across recompiles
(a ``refresh(full=True)`` rebuilt some components and silently zeroed
their counters while others accumulated).  The registry fixes both:

* **Typed metrics** - ``Counter`` (monotone int/float adds),
  ``Gauge`` (last-set value), ``Histogram`` (count/sum/min/max
  aggregate, constant memory), ``BucketHistogram`` (fixed log-scale
  buckets with exact quantile-*bound* queries - the always-on latency
  percentile store, still constant memory) - all keyed by dotted
  namespaced names (``"serving.server.joined_steps"``,
  ``"cluster.router.e2e_seconds"``).
* **Snapshot / delta / reset** - ``snapshot()`` is a cheap flat
  ``{name: number}`` dict (histograms expand to ``name.count`` etc.),
  ``delta(before)`` subtracts two snapshots, ``reset(prefix)`` zeroes.
  These feed the BENCH ``metrics`` blocks that ``check_bench.py``
  gates on.
* **One reset semantics** - metrics live in the *registry*, not in the
  component.  A component that is rebuilt (a streaming
  ``refresh(full=True)`` recompiling its ``PatternServer``, the
  sharded-window protocol re-planning its router) re-attaches to the
  same registry and its counters *accumulate*; the only way to zero a
  metric is an explicit ``reset()``.  Components own a registry by
  default and accept one (``metrics=``) to opt into a longer-lived
  scope.
* **StatsView** - a ``MutableMapping`` facade over one namespace so the
  existing ``self.stats["joined_steps"] += n`` call sites (and every
  test reading ``server.stats[...]``) keep working verbatim while the
  storage moves into the registry.

The registry is pure host-side Python bookkeeping: it never touches
the device, adds zero device dispatches, and is cheap enough to stay on in
production (a few dict/int ops per already-expensive device batch).
"""
from __future__ import annotations

import bisect
import warnings
from collections.abc import MutableMapping
from typing import Dict, Iterable, Iterator, List, Optional, Union

Number = Union[int, float]


class Counter:
    """Monotone additive metric (int or float).  ``inc`` only - a
    counter that needs to go down is a ``Gauge``."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def set(self, v: Number) -> None:
        """Assignment is NOT a counter operation: counters are monotone
        (rates, deltas and the Prometheus exposition all assume it).
        Setting any non-zero value raises; setting 0 still works (it is
        a reset) but warns - route resets through
        ``MetricsRegistry.reset(prefix)``, the one sanctioned zeroing
        path."""
        if v != 0:
            raise ValueError(
                f"counter {self.name!r}: direct assignment of {v!r} "
                "breaks monotonicity - use inc(), or a Gauge for a "
                "value that moves both ways"
            )
        warnings.warn(
            f"counter {self.name!r}: reset-by-assignment is deprecated"
            " - use MetricsRegistry.reset(prefix) instead",
            stacklevel=3,
        )
        self.value = 0

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-written value (queue depths, live fractions, knobs)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0


class Histogram:
    """Constant-memory aggregate of an observed distribution:
    count / sum / min / max (enough for mean + extremes in reports
    without storing samples)."""

    __slots__ = ("name", "count", "sum", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def observe(self, v: Number) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def reset(self) -> None:
        self.count = 0
        self.sum = 0
        self.min = float("inf")
        self.max = float("-inf")

    def summary(self) -> Dict[str, Number]:
        out = {"count": self.count, "sum": self.sum}
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
            out["mean"] = self.sum / self.count
        return out


def _log_bounds(lo: float, hi: float, per_decade: int) -> List[float]:
    import math

    n = int(round(math.log10(hi / lo) * per_decade))
    return [lo * 10.0 ** (i / per_decade) for i in range(n + 1)]


class BucketHistogram(Histogram):
    """Fixed log-scale-bucket histogram: the always-on latency
    percentile store.  Memory is constant (one int per bucket) and
    ``observe`` is one ``bisect`` + three compares, so it can sit on
    the per-query hot path.

    ``quantile(q)`` returns an exact *bound*: the upper edge of the
    bucket containing the q-th observation (the true value is within
    one bucket width, ~33% at 8 buckets/decade; for the overflow
    bucket the tracked exact ``max`` is returned).  ``summary()`` adds
    ``p50``/``p95``/``p99`` to the base count/sum/min/max/mean, so
    registry ``snapshot()`` expands it into the BENCH metrics blocks
    with no registry changes."""

    # 1 µs .. 100 s at 8 buckets per decade: 64 finite buckets + one
    # overflow - covers every latency this repo measures (a device
    # dispatch is ~100 µs, a full cluster drain tens of ms).
    BOUNDS: List[float] = _log_bounds(1e-6, 1e2, 8)

    __slots__ = ("counts",)

    def observe(self, v: Number) -> None:
        super().observe(v)
        self.counts[bisect.bisect_left(self.BOUNDS, v)] += 1

    def reset(self) -> None:
        super().reset()
        self.counts = [0] * (len(self.BOUNDS) + 1)

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-th observation
        (0 <= q <= 1); 0.0 when empty, exact max for overflow."""
        if not self.count:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                if i < len(self.BOUNDS):
                    return self.BOUNDS[i]
                return self.max
        return self.max

    def summary(self) -> Dict[str, Number]:
        out = super().summary()
        if self.count:
            out["p50"] = self.quantile(0.50)
            out["p95"] = self.quantile(0.95)
            out["p99"] = self.quantile(0.99)
        return out


class MetricsRegistry:
    """A flat namespace of typed metrics.  Name collisions within one
    registry return the *same* metric object (that is what makes
    counters survive component rebuilds: the new component re-attaches
    by name), but a name registered as one type cannot be re-registered
    as another."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get(self, name: str, cls):
        got = self._metrics.get(name)
        if got is None:
            got = self._metrics[name] = cls(name)
        elif not isinstance(got, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(got).__name__}, not {cls.__name__}"
            )
        return got

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def bucket_histogram(self, name: str) -> BucketHistogram:
        return self._get(name, BucketHistogram)

    def view(self, namespace: str,
             keys: Iterable[str] = ()) -> "StatsView":
        """A dict-like facade over ``{namespace}.{key}`` counters -
        the drop-in replacement for the old ad-hoc ``stats`` dicts."""
        return StatsView(self, namespace, keys)

    # ---------------------------------------------------------- export
    def snapshot(self, prefix: str = "") -> Dict[str, Number]:
        """Flat ``{name: value}`` dict of every metric under
        ``prefix`` (histograms expand to ``name.count`` / ``.sum`` /
        ``.min`` / ``.max`` / ``.mean``).  JSON-ready: this is the
        BENCH artifacts' ``metrics`` block."""
        out: Dict[str, Number] = {}
        for name, m in sorted(self._metrics.items()):
            if prefix and not name.startswith(prefix):
                continue
            if isinstance(m, Histogram):
                for k, v in m.summary().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = m.value
        return out

    def delta(self, before: Dict[str, Number],
              prefix: str = "") -> Dict[str, Number]:
        """``snapshot() - before``, per key (keys absent from
        ``before`` count from 0) - per-phase attribution without
        resetting anything."""
        now = self.snapshot(prefix)
        return {k: v - before.get(k, 0) for k, v in now.items()}

    def reset(self, prefix: str = "") -> None:
        """THE reset semantics: metrics zero here and nowhere else.
        Component rebuilds (recompiles, re-plans) must re-attach, never
        zero."""
        for name, m in self._metrics.items():
            if not prefix or name.startswith(prefix):
                m.reset()


class StatsView(MutableMapping):
    """Mutable-mapping facade over one registry namespace: the
    component keeps writing ``stats["key"] += n`` and tests keep
    reading ``stats["key"]``, while the values live in (and persist
    with) the registry's ``Counter``s.  Declared ``keys`` pre-register
    so iteration shows zeros; assigning an unknown key registers it."""

    __slots__ = ("_registry", "_ns", "_keys")

    def __init__(self, registry: MetricsRegistry, namespace: str,
                 keys: Iterable[str] = ()):
        self._registry = registry
        self._ns = namespace
        self._keys = list(dict.fromkeys(keys))
        for k in self._keys:
            registry.counter(f"{namespace}.{k}")

    def _full(self, key: str) -> str:
        return f"{self._ns}.{key}"

    def __getitem__(self, key: str) -> Number:
        if key not in self._keys:
            raise KeyError(key)
        return self._registry.counter(self._full(key)).value

    def __setitem__(self, key: str, value: Number) -> None:
        if key not in self._keys:
            self._keys.append(key)
        c = self._registry.counter(self._full(key))
        # ``stats[k] += n`` arrives here as setitem(k, old + n): apply
        # the non-negative delta as an inc.  A decrease is either the
        # deprecated reset-to-0 idiom (Counter.set warns) or a
        # monotonicity violation (Counter.set raises).
        if value >= c.value:
            c.inc(value - c.value)
        else:
            c.set(value)

    def __delitem__(self, key: str) -> None:  # pragma: no cover
        raise TypeError("registry-backed stats cannot drop keys")

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return f"StatsView({self._ns}, {dict(self)})"


_global: Optional[MetricsRegistry] = None


def global_registry() -> MetricsRegistry:
    """The process-wide registry - for code with no natural owner
    (launch scripts, ad-hoc probes).  Components default to a private
    registry instead, so unrelated instances never share counters."""
    global _global
    if _global is None:
        _global = MetricsRegistry()
    return _global
