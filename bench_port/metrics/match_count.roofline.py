"""match_count's share of its roofline over the profiled slice
(``roofline/match_count.py``).  Layer: kernel (``csrc/match_count.cu``)."""
from bench_port.lib.readers import roofline_share


def read(art):
    return roofline_share(art, "match_count") if art.kind == "mine" else None
