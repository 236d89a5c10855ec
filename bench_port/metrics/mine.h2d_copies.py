"""Host-to-device copies per mining job: the profiled slice's
``Memcpy HtoD`` events over its jobs.  Layer: encode and upload
(``mining.encoding``, ``mining.driver``'s per-chunk uploads)."""


def read(art):
    if art.kind != "mine" or art.slice is None:
        return None
    n = sum(1 for name, cat, _, _ in art.slice.device
            if cat == "gpu_memcpy" and "HtoD" in name)
    return n / art.slice.ops
