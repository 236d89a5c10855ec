"""Self time of the interval ``serving.fused_walk`` (the dispatch of the
one ``trie_walk`` launch a batch; sampled tracing records no fenced
half), ms per batch; 0 where the program records none.  Layer: fused
walk dispatch (``serving.batch`` ``fused_trie_walk``)."""
from bench_port.lib.readers import span_self_ms_per_op


def read(art):
    return span_self_ms_per_op(art, names=("serving.fused_walk",))
