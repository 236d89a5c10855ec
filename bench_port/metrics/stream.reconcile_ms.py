"""Self time of ``streaming.refresh`` and everything under it but the
frontier walk (the dirty set, the bank's extension, the recount of
recovered and new rows, the server rebuild, the mask, a compacting
``streaming.full_refresh``), ms per refresh.  Layer: refresh reconcile."""
from bench_port.lib.stream_readers import in_tree, self_ms


def read(art):
    return self_ms(art, "refresh", lambda name, anc: (
        in_tree("streaming.refresh", name, anc)
        and not in_tree("streaming.frontier", name, anc)))
