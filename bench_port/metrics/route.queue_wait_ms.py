"""Mean of the router's ``cluster.router.queue_wait_seconds`` over the
window (a query's admission to the launch of the flush carrying it), ms
per query.  Layer: queue (the admission queue and its ``flush_batch`` /
``max_wait`` triggers)."""
from bench_port.lib.route_readers import histogram_mean_ms


def read(art):
    return histogram_mean_ms(art, "queue_wait_seconds")
