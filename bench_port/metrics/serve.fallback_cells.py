"""(sequence, pattern) cells the host oracle decided, per batch (counter
``host_fallback_cells``).  Layer: escalation and host oracle."""


def read(art):
    if art.kind != "query" or not art.ops:
        return None
    return art.counters["host_fallback_cells"] / art.ops
