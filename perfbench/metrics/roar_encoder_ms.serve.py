"""Sampler and model: device ms a profiled clip batch in the kernels the
program's `egom2p.roar.encoder` spans launched, every ROAR step's (their
own time, not the device's waits)."""
from perfbench import registry


def read(layer):
    return registry.device_ms_a_unit(layer, "egom2p.roar.encoder")
