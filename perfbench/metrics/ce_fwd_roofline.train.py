"""CE kernels (forward): the loss's head work over its live target rows in
the profiled stretch, as its least time at the peaks, over the device time
of the kernels matched by this metric's pattern files; nothing where no
kernel matched (a plain CE path)."""
from perfbench.core import load_patterns


def read(layer):
    t, work = layer.get("trace"), layer.get("work")
    if t is None or not work:
        return None
    secs = t.kernel_seconds(load_patterns("ce_fwd_roofline.train"))
    return 100.0 * work["ce_fwd_bound_s"] / secs if secs > 0 else None
