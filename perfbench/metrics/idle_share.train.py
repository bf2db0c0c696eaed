"""Device (rank 0 across chips): the share of a step's time with no kernel
running: one minus the kernels' busy time a profiled step over the mean
interval of the window's unprofiled steps (the profiler's own host work
stretches the profiled steps' wall time, not their device work)."""


def read(layer):
    t, n, unit = layer.get("trace"), layer.get("traced_units", 0), layer.get("untraced_unit_s", 0)
    if t is None or n <= 0 or unit <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / 1e6 / n / unit)
