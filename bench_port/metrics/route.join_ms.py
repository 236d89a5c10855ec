"""Self time of spans ``cluster.flush`` and ``cluster.fence`` and
everything under them (the shared encoding, the shard server's
``serving.*`` launch, its reads back and escalation, the L2 fill), ms per
batch (one flush).  Layer: join."""
from bench_port.lib.route_readers import in_trees, per, self_us

ROOTS = ("cluster.flush", "cluster.fence")


def read(art):
    us = self_us(art, lambda name, anc: in_trees(ROOTS, name, anc))
    return per(art, None if us is None else us / 1e3, "batch")
