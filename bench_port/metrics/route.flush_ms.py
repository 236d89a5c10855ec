"""Mean of the router's ``cluster.router.flush_seconds`` over the window
(a flush's launch to its batch fenced, the client's admissions in
between included), ms per batch.  Layer: pipeline (launch, the work
interleaved with it, the fence)."""
from bench_port.lib.route_readers import histogram_mean_ms


def read(art):
    return histogram_mean_ms(art, "flush_seconds")
