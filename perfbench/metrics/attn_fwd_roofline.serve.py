"""Attention kernels (generation): the attention work counted at the model's
blocks in the profiled stretch, as its least time at the peaks, over the
device time of the kernels matched by this metric's pattern files."""
from perfbench.core import load_patterns


def read(layer):
    t, work = layer.get("trace"), layer.get("work")
    if t is None or not work:
        return None
    secs = t.kernel_seconds(load_patterns("attn_fwd_roofline.serve"))
    return 100.0 * work["attn_fwd_bound_s"] / secs if secs > 0 else None
