"""Extension scans of the incremental re-mine a refresh: the change of the
bank's ``frontier_scans`` counter over that of ``refreshes`` (incremental
refreshes) in the window.  Layer: incremental frontier."""


def read(art):
    if art.kind != "stream" or not art.counters.get("refreshes"):
        return None
    return art.counters["frontier_scans"] / art.counters["refreshes"]
