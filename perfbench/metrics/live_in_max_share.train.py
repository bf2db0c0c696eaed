"""Train step: each fed batch's fullest row's live inputs over the input
slots a row, mean over the batches, in %, from the program's counters."""
from perfbench import registry


def read(layer):
    c = registry.counters(layer)
    keys = ("train.live_inputs_max", "train.input_slots", "train.rows", "train.batches")
    if c is None or any(k not in c for k in keys) or not c["train.input_slots"]:
        return None
    per_row = c["train.input_slots"] / c["train.rows"]
    return 100.0 * c["train.live_inputs_max"] / c["train.batches"] / per_row
