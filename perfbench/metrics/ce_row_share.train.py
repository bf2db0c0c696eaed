"""Train step: the rows the loss's heads compute over the rows they would
compute if each ran over every decoder row (the heads present x the decoder
rows), every fed batch, in %."""
from perfbench import registry

KEYS = ("train.ce_rows", "train.ce_row_slots")


def read(layer):
    c = registry.counters(layer)
    if c is None or any(k not in c for k in KEYS):
        return None
    slots = c["train.ce_row_slots"]
    return 100.0 * c["train.ce_rows"] / slots if slots else None
