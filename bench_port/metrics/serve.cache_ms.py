"""Self time of span ``serving.cache`` (canonical fingerprints and the row
LRU), ms per batch.  Layer: cache (``serving.server``)."""
from bench_port.lib.readers import span_self_ms_per_op


def read(art):
    return span_self_ms_per_op(art, names=("serving.cache",))
