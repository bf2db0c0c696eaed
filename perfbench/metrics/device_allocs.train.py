"""Device: the caching allocator's calls for device memory (cudaMalloc) a
profiled step, from the program's `device.allocs` counter."""
from perfbench import registry


def read(layer):
    c = registry.counters(layer)
    if c is None or "device.allocs" not in c or not c["units"]:
        return None
    return c["device.allocs"] / c["units"]
