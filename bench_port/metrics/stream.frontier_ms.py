"""Self time of ``streaming.frontier`` and everything under it (the
incremental re-mine's walk: its ``mining.*`` spans, prepare, dispatch,
aggregate, group, children and rebuild), ms per refresh.  Layer:
incremental frontier."""
from bench_port.lib.stream_readers import in_tree, self_ms


def read(art):
    return self_ms(art, "refresh", lambda name, anc: in_tree(
        "streaming.frontier", name, anc))
