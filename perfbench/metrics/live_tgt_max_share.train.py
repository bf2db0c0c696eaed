"""Train step: each fed batch's fullest row's live targets over the target
slots a row, mean over the batches, in %, from the program's counters."""
from perfbench import registry


def read(layer):
    c = registry.counters(layer)
    keys = ("train.live_targets_max", "train.target_slots", "train.rows", "train.batches")
    if c is None or any(k not in c for k in keys) or not c["train.target_slots"]:
        return None
    per_row = c["train.target_slots"] / c["train.rows"]
    return 100.0 * c["train.live_targets_max"] / c["train.batches"] / per_row
