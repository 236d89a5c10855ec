"""Idle share of the device over the profiled slice of an open-loop cell:
100 less the union of kernel and copy intervals over the slice's wall.
Layer: device."""
from bench_port.lib.readers import device_idle


def read(art):
    return device_idle(art, "open")
