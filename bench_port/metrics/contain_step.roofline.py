"""contain_step's share of its roofline over the profiled slice
(``roofline/contain_step.py``).  Layer: kernel (``csrc/containment.cu``)."""
from bench_port.lib.readers import roofline_share


def read(art):
    return roofline_share(art, "contain_step") if art.kind == "query" else None
