"""Share of the mining jobs' wall that is not the miner's own device time
(``device_seconds``: launch to synchronize per chunk), over the traced
window.  Layer: host frontier and aggregate (``mining.driver``,
``mining.engine``)."""


def read(art):
    if art.kind != "mine" or not art.counters.get("job_seconds"):
        return None
    c = art.counters
    return 100.0 * (c["job_seconds"] - c["device_seconds"]) / c["job_seconds"]
