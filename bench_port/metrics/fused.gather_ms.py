"""Self time of span ``serving.fused_gather`` (the finalize's host gather
of the walk's accept and overflow bits into the batch's rows, after
their device reads), ms per batch; 0 where the program records no such
span.  Layer: fused finalize (``serving.server``
``_finalize_trie_fused``)."""
from bench_port.lib.readers import span_self_ms_per_op


def read(art):
    return span_self_ms_per_op(art, names=("serving.fused_gather",))
