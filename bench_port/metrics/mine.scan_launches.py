"""match_count launches per mining job over the traced window (the port's
``ops.launches`` counter; equals the miner's ``n_device_calls``).
Layer: device-scan dispatch (``mining.driver`` -> ``kernels.match_count``)."""


def read(art):
    if art.kind != "mine" or not art.ops:
        return None
    return art.counters["match_count"] / art.ops
