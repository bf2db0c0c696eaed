"""The program's own spans and counters (egom2p_torch/core/tracing.py), read
through the module the run loaded: nothing here imports the program.  A
span's numbers come from the profiled stretch's trace, by the program's own
`tracing.spans`, and a number a unit divides by the units the driver
profiled; the counters count every batch the run fed (the allocator's, the
profiled units).  None wherever there is nothing to read: no such module,
a layer without a trace (no profiled stretch in this process), no such span
or counter."""
from __future__ import annotations

import sys
from typing import Dict, Optional

MODULE = "egom2p_torch.core.tracing"


def _tracing(layer):
    t = layer.get("trace")
    return sys.modules.get(MODULE) if t is not None else None


def device_ms_a_unit(layer, span: str) -> Optional[float]:
    """Device ms a profiled unit in the kernels the spans named `span`
    launched."""
    tracing, n = _tracing(layer), layer.get("traced_units", 0)
    if tracing is None or n <= 0:
        return None
    t = layer["trace"]
    s = tracing.spans(t.host, t.kernels).get(span)
    return None if s is None or s["device_ms"] is None else s["device_ms"] / n


def counters(layer) -> Optional[Dict]:
    """The counters' totals, with "units" (the units profiled) beside them."""
    tracing = _tracing(layer)
    if tracing is None:
        return None
    snap = tracing.snapshot()
    return dict(snap["counters"], units=snap["units"])


def host_ms_a_step(layer, span: str) -> Optional[float]:
    """Host ms a profiled step in the profile's ranges named `span` (the
    trace's host ranges: rank 0's across chips)."""
    t, n = layer.get("trace"), layer.get("traced_units", 0)
    if t is None or n <= 0:
        return None
    xs = [e - s for name, s, e in t.host if name == span]
    return sum(xs) / 1e3 / n if xs else None
