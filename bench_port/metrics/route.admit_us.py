"""Self time of span ``cluster.submit`` and everything under it but the
flushes it fires (``cluster.flush``: fingerprints, the L1 / L2 lookups,
the in-flight dedup and the enqueue), us per admitted query.  Layer:
admission (``ClusterRouter.submit``)."""
from bench_port.lib.route_readers import in_trees, per, self_us


def read(art):
    return per(art, self_us(art, lambda name, anc: (
        in_trees(("cluster.submit",), name, anc)
        and not in_trees(("cluster.flush",), name, anc))), "query")
