"""Attention kernels (training, forward and backward): the attention work
counted at the model's blocks in the profiled stretch, as its least time at
the peaks, over the device time of the kernels matched by this metric's
pattern files."""
from perfbench.core import load_patterns


def read(layer):
    t, work = layer.get("trace"), layer.get("work")
    if t is None or not work:
        return None
    secs = t.kernel_seconds(load_patterns("attn_roofline.train"))
    bound = work["attn_fwd_bound_s"] + work["attn_bwd_bound_s"]
    return 100.0 * bound / secs if secs > 0 else None
