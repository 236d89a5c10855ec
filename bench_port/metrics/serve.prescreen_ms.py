"""Self time of spans ``serving.encode`` and ``serving.prescreen_host``,
ms per batch.  Layer: encode and prescreen (``serving.server``,
``serving.batch``)."""
from bench_port.lib.readers import span_self_ms_per_op


def read(art):
    return span_self_ms_per_op(
        art, names=("serving.encode", "serving.prescreen_host"))
