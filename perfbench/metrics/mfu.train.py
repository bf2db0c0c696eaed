"""The whole step's share of the dense bf16 peak on every chip: model FLOPs
of the window's steps (all ranks) outside the profiled stretch, over their
seconds times the chips."""


def read(layer):
    s = layer.get("untraced_s", 0.0)
    if s <= 0:
        return None
    return 100.0 * layer["untraced_flops"] / (s * layer["chips"] * layer["peak_flops"])
