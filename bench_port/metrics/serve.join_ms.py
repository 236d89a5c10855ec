"""Self time of spans ``serving.batch`` and ``serving.finalize_rows`` and
everything under them but the encode, the prescreen and the host oracle
(the index build, the join's launches, the reads back, escalation), ms
per batch.  Layer: join (``serving.batch`` ``_join`` / ``_step_once``)."""
from bench_port.lib.readers import span_self_ms_per_op

ROOTS = ("serving.batch", "serving.finalize_rows")


def read(art):
    return span_self_ms_per_op(
        art, names=ROOTS, under=ROOTS,
        exclude=("serving.encode", "serving.prescreen_host",
                 "serving.oracle"))
