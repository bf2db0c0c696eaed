"""Data: host ms a profiled step in the program's `egom2p.data.to_device`
span, read from the profile's host ranges (rank 0's across chips)."""
from perfbench import registry


def read(layer):
    return registry.host_ms_a_step(layer, "egom2p.data.to_device")
