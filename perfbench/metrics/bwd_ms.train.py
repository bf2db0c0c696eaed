"""Train step: device ms a profiled step in the kernels the program's
`egom2p.train.backward` spans launched (their own time, not the
device's waits)."""
from perfbench import registry


def read(layer):
    return registry.device_ms_a_unit(layer, "egom2p.train.backward")
