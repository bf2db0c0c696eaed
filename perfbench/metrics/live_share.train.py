"""Train step: the program's live input and target tokens over the input
and target slots its encoder and decoder compute, every fed batch, in %."""
from perfbench import registry

KEYS = ("train.live_inputs", "train.live_targets", "train.input_slots", "train.target_slots")


def read(layer):
    c = registry.counters(layer)
    if c is None or any(k not in c for k in KEYS):
        return None
    slots = c["train.input_slots"] + c["train.target_slots"]
    return 100.0 * (c["train.live_inputs"] + c["train.live_targets"]) / slots if slots else None
