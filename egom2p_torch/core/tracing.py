"""Spans and counters on the profiler's clock.

A span names a stretch of the program's work (`egom2p.roar.encoder`,
`egom2p.train.backward`, ...).  While a torch profiler records
(`torch.profiler.profile`, or `run_training --profile`), `span(name)` opens
`torch.profiler.record_function(name)`: the profile holds it as a host
range beside the device kernels, so an idle gap on the device is named by
the span that covers it.  With no profiler it hands out one shared null
context, so the program pays one check a span and there is no other
switch.

A span's times are read from the profile afterwards (`spans`): its host
milliseconds, and its device milliseconds, the summed time of the kernels
and copies launched while it was open.  The program drives one stream, on
which the device runs its work in the order it was launched, so the n-th
launch on the host is the n-th kernel on the device (save a copy or a fill
of nothing, which puts none there).  A kernel's own time
counts, never the device's waits for the host, and a launch from any thread
counts for the span open at the time (the backward's kernels come from
autograd's device thread).

A counter (`count`) adds up a number the host already holds
(`train.live_inputs`, ...), always, profiler or not: a reader divides it by
the count of what it counted.  A span opened with `unit=True` starts the
next unit (a clip batch in serving, `egom2p.clip`; a training step, at its
`egom2p.data.fetch`); on CUDA the allocator's `num_device_alloc` moves
from a unit's start to the end of each of its outermost spans go into the
counter `device.allocs`, over the units profiled.  `snapshot()` returns the
counters and the units, `reset()` forgets them.
"""
from __future__ import annotations

import bisect
import contextlib
import itertools
import re
from typing import Dict, List, Optional, Tuple

import torch

_NULL = contextlib.nullcontext()
PREFIX = "egom2p."
# the host calls that put work on the device: one kernel, copy or fill each
LAUNCH = re.compile(r"^cu(?:da)?(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset)")

_counters: Dict[str, float] = {}
_units = 0
_depth = 0                       # spans open
_alloc_mark: Optional[int] = None

Event = Tuple[str, float, float]  # (name, start us, end us) on the profiler's clock


def count(name: str, value) -> None:
    """Add `value` to the counter `name`."""
    _counters[name] = _counters.get(name, 0) + value


def span(name: str, unit: bool = False):
    """A context manager around a stretch of work; `unit=True` starts the
    next unit with it."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name, unit)


def _device_allocs() -> Optional[int]:
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.memory_stats().get("num_device_alloc")


class _Span:
    __slots__ = ("name", "unit", "fn")

    def __init__(self, name: str, unit: bool):
        self.name, self.unit = name, unit

    def __enter__(self):
        global _units, _alloc_mark, _depth
        if self.unit:
            _units += 1
            _alloc_mark = _device_allocs()
        _depth += 1
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        global _alloc_mark, _depth
        self.fn.__exit__(*exc)
        _depth -= 1
        if _depth == 0 and _alloc_mark is not None:
            now = _device_allocs()
            count("device.allocs", now - _alloc_mark)
            _alloc_mark = now
        return False


def snapshot() -> Dict:
    """{"units": units profiled, "counters": {name: total}}."""
    return {"units": _units, "counters": dict(_counters)}


def reset() -> None:
    """Forget every counter and unit (with no span open)."""
    global _units, _alloc_mark, _depth
    _counters.clear()
    _units, _alloc_mark, _depth = 0, None, 0


def events(prof) -> Tuple[List[Event], List[Event]]:
    """A finished profile's host events and its device kernels and copies
    (annotated ranges also sit on the device's timeline: left out)."""
    host, kernels = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(
                    (PREFIX, "Optimizer.")):
                kernels.append(item)
        else:
            host.append(item)
    return host, kernels


def _kind(name: str) -> str:
    """A device operation's kind: "Memset", "Memcpy" or a kernel ("")."""
    return name[:6] if name.startswith(("Memset", "Memcpy")) else ""


def _paired(host: List[Event], kernels: List[Event]) -> Optional[List[Tuple[float, float]]]:
    """Each device operation's launch time and own time, in launch order:
    the n-th launch of the device's order is the n-th operation, save a copy
    or a fill launched with nothing to do, which puts none on the device.
    None where they do not pair (a kernel launched and not run, or run and
    not launched, or out of kind)."""
    launches = sorted((s, _kind(m.group(1))) for m, s in
                      ((LAUNCH.match(n), s) for n, s, _ in host) if m)
    ops = sorted((s, e, _kind(n)) for n, s, e in kernels)
    out, j = [], 0
    for s, e, kind in ops:
        while j < len(launches) and launches[j][1] != kind:
            if not launches[j][1]:
                return None
            j += 1
        if j == len(launches):
            return None
        out.append((launches[j][0], e - s))
        j += 1
    return out if out and all(kind for _, kind in launches[j:]) else None


def spans(host: List[Event], kernels: List[Event]) -> Dict[str, Dict]:
    """{span name: {"calls", "host_ms", "device_ms"}} of the program's spans
    in a profile's host events: totals over the calls.  "device_ms" is the
    time of the kernels, copies and fills launched while a span was open,
    None where the launches and the device's operations do not pair."""
    ranges: Dict[str, List[Tuple[float, float]]] = {}
    for name, s, e in host:
        if name.startswith(PREFIX):
            ranges.setdefault(name, []).append((s, e))
    paired = _paired(host, kernels)
    if paired:
        at = [t for t, _ in paired]     # ascending: launch order
        upto = list(itertools.accumulate((d for _, d in paired), initial=0.0))
    out = {}
    for name, rs in ranges.items():
        device = None
        if paired:  # a span's launches are a run of the launches
            device = sum(upto[bisect.bisect_right(at, e)] - upto[bisect.bisect_left(at, s)]
                         for s, e in rs) / 1e3
        out[name] = {"calls": len(rs), "host_ms": sum(e - s for s, e in rs) / 1e3,
                     "device_ms": device}
    return out


def table(prof) -> str:
    """The program's spans in a finished profile (calls, host and device
    ms, totals), then the counters with each a unit."""
    snap = snapshot()
    n = max(snap["units"], 1)
    lines = [f"{'span':<28}{'calls':>7}{'host ms':>12}{'device ms':>12}"]
    for name, s in sorted(spans(*events(prof)).items()):
        dev = "-" if s["device_ms"] is None else f"{s['device_ms']:.3f}"
        lines.append(f"{name:<28}{s['calls']:>7}{s['host_ms']:>12.3f}{dev:>12}")
    for name, v in sorted(snap["counters"].items()):
        lines.append(f"{name:<28}{v:>12g} ({v / n:g} a unit)")
    lines.append(f"units {snap['units']}")
    return "\n".join(lines)
