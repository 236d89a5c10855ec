"""Observability: span tracer, metrics registry, flight recorder,
exposition and SLO rules, with the same metric and span names as the
JAX package.

* ``metrics``  - ``MetricsRegistry``: typed counters / gauges /
                 histograms under dotted namespaces; ``BucketHistogram``
                 latency percentiles; ``StatsView`` facades.
* ``trace``    - the span tracer (off by default; sampled mode never
                 fences the device).
* ``flight``   - ``FlightRecorder``: a ring buffer of the last N kept
                 span-trees + prefix-scoped metric deltas, dumped to
                 JSONL on demand, on anomaly, or by the watchdog.
* ``export``   - ``prometheus_text()`` exposition of any registry, the
                 strict ``validate_exposition()`` grammar check, and
                 ``MetricsExporter`` (periodic JSONL snapshots on an
                 injectable clock).
* ``slo``      - declarative ``SloRule``s and the in-process
                 ``SloWatchdog`` (registry deltas, breach counter,
                 flight-recorder dumps); attach one with
                 ``ServingCluster.attach_watchdog``.
"""
from . import trace  # noqa: F401
from .export import (  # noqa: F401
    MetricsExporter,
    prometheus_text,
    validate_exposition,
)
from .flight import FlightRecorder  # noqa: F401
from .metrics import (  # noqa: F401
    BucketHistogram,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StatsView,
    global_registry,
)
from .slo import (  # noqa: F401
    Breach,
    SloRule,
    SloWatchdog,
    evaluate,
    load_rules,
)
