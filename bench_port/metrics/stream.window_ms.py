"""Self time of ``streaming.observe`` and of ``streaming.ring`` and
``streaming.mask`` under it (the ring's support update and evictions, the
tombstone cut and its mask), ms per batch.  Layer: window ring and
tombstones."""
from bench_port.lib.stream_readers import self_ms

NAMES = ("streaming.ring", "streaming.mask")


def read(art):
    return self_ms(art, "batch", lambda name, anc: (
        name == "streaming.observe"
        or (name in NAMES and "streaming.observe" in anc)))
