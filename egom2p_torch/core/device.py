"""The device a public helper of the port runs on."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device.  The port's helpers default to "cuda":
    without a CUDA device that raises, and the CPU is used only when the
    caller asks for it with device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device found: this runs on the first CUDA device by '
                           'default; pass device="cpu" to run it on the CPU')
    return dev
