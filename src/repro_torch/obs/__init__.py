"""Observability: span tracer and metrics registry.

Only the two modules the mining path reports through are ported here
(``trace`` and ``metrics``), with the same ``mining.*`` metric and span
names as the JAX package.
"""
from . import trace  # noqa: F401
from .metrics import (  # noqa: F401
    BucketHistogram,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StatsView,
    global_registry,
)
