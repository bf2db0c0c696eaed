"""What every driver shares: the benchmark's files found by name, the
device check, the measured window, the profiled stretch and its reduction
to busy time, kernel time by pattern and idle gaps, and the checks that
decide `correct`.

Nothing here imports the program; the drivers import it, inside their
functions.
"""
from __future__ import annotations

import json
import math
import os
import re
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# what the run may not hold once the window has closed, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "egom2p_tpu")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def peaks() -> Dict[str, float]:
    return load_json("peaks.json")


def process_start() -> float:
    """This process's start on the `time.time()` clock (Linux /proc), or the
    harness module's import time where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules() -> List[str]:
    """FORBIDDEN names that sys.modules holds, compared as whole top-level
    names (egom2p_torch is not egom2p_tpu)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def fixed_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds."""
    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")


# ------------------------------------------------------------------ window
@dataclass
class Window:
    """The measured window: it opens at `open()` and closes at the end of
    the first unit of work that completes `seconds` after it opened."""
    seconds: float
    start: float = 0.0
    end: float = 0.0
    marks: List[float] = field(default_factory=list)

    def open(self) -> None:
        self.start = time.perf_counter()
        self.marks = [self.start]

    def mark(self) -> bool:
        """Record a finished unit of work; True once the window has closed."""
        now = time.perf_counter()
        self.marks.append(now)
        if now - self.start >= self.seconds:
            self.end = now
            return True
        return False

    @property
    def length(self) -> float:
        return self.end - self.start

    @property
    def intervals(self) -> List[float]:
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def percentile(values: List[float], q: float) -> float:
    """Linear-interpolated percentile, q in [0, 100]."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ------------------------------------------------------------------- trace
@dataclass
class Trace:
    """The reduction of one profiled stretch: device kernels and copies as
    (name, start_us, end_us), host annotations as (name, start_us, end_us),
    and the stretch's wall length."""
    kernels: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    wall_s: float

    @classmethod
    def from_profile(cls, prof, wall_s: float) -> "Trace":
        import torch
        kernels, host = [], []
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # kernels and copies only: annotated ranges also sit on the device timeline
                if getattr(e, "is_user_annotation", False) or e.name.startswith(
                        ("Optimizer.", "perfbench:")):
                    continue
                kernels.append((e.name, float(start), float(end)))
            else:
                host.append((e.name, float(start), float(end)))
        return cls(kernels, host, wall_s)

    def busy_us(self) -> float:
        """Length of the union of the kernels' intervals."""
        spans = sorted((s, e) for _, s, e in self.kernels)
        total, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def kernel_seconds(self, patterns: List[str]) -> float:
        """Summed device time of the kernels whose name matches any pattern."""
        rx = [re.compile(p) for p in patterns]
        return sum(e - s for n, s, e in self.kernels if any(r.search(n) for r in rx)) / 1e6

    def device_ops(self, top: int = 10) -> List[List]:
        by = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n[:200], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The longest stretches with no kernel running, each named by the
        innermost host range that covers its middle (the harness's own
        `perfbench:` spans, or the host op in flight)."""
        spans = sorted((s, e) for _, s, e in self.kernels)
        gaps, cur_e = [], None
        for s, e in spans:
            if cur_e is not None and s > cur_e:
                gaps.append((cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (a + b) / 2
            covering = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            spans_h = [c for c in covering if c[1].startswith("perfbench:")]
            ops = [c for c in covering if not c[1].startswith("perfbench:")]
            inner = min(ops)[1] if ops else "python between ops"
            name = inner if not spans_h else f"{min(spans_h)[1]} / {inner}"
            out.append([name[:200], (b - a) / 1e6])
        return out


def load_patterns(metric: str) -> List[str]:
    """Every regex line of the pattern files in metrics/<metric>/ (one file
    per kernel family: a later kernel adds a file)."""
    d = os.path.join(BENCH_DIR, "metrics", metric)
    pats = []
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".txt"):
            with open(os.path.join(d, fn)) as f:
                pats += [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    return pats


# ------------------------------------------------------------------ checks
@dataclass
class Check:
    """One number compared beside its limit: it passes at or under it."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit) and not math.isnan(self.value)


@dataclass
class RunResult:
    """What a driver hands back: end-to-end readings, the per-layer
    context the metric readers take, the checks, and the device figures."""
    e2e: Dict[str, float]
    layer: Dict
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    count: int
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict] = None
