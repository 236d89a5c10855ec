"""Self time of span ``serving.fused_cells`` (the fused layout's pick of
the (sequence, subtree) cells to walk: the subtree gate, the padded cell
table and its upload), ms per batch; 0 where the program records no such
span.  Layer: fused cell pick
(``serving.server`` ``_launch_trie_fused``)."""
from bench_port.lib.readers import span_self_ms_per_op


def read(art):
    return span_self_ms_per_op(art, names=("serving.fused_cells",))
