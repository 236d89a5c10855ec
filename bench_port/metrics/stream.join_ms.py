"""Self time of the ``serving.*`` spans under ``streaming.observe`` (the
arrivals' ``PatternServer.exact_rows``: encode, prescreen, the flat join,
its reads back and escalation), ms per batch.  Layer: window join."""
from bench_port.lib.stream_readers import self_ms


def read(art):
    return self_ms(art, "batch", lambda name, anc: (
        name.startswith("serving.") and "streaming.observe" in anc))
