"""Share of the window's queries answered from the server's row LRU
(counters ``cache_hits`` / ``queries``; a sequence repeated inside one
batch is answered once and counts as neither).  Layer: cache
(``serving.server``)."""


def read(art):
    if art.kind != "query" or not art.counters.get("queries"):
        return None
    return 100.0 * art.counters["cache_hits"] / art.counters["queries"]
