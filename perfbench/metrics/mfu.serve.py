"""The whole batch's share of the dense bf16 peak: model FLOPs (generation
at the live tokens, the Cosmos encode and decode from the networks' shapes)
of the window's batches outside the profiled stretch, over their seconds."""


def read(layer):
    s = layer.get("untraced_s", 0.0)
    return 100.0 * layer["untraced_flops"] / (s * layer["peak_flops"]) if s > 0 else None
