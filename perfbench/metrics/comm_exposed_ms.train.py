"""Distributed: rank 0's collective kernels (this metric's pattern files)
overlapped by no other kernel, per profiled step, in ms."""
import re

from perfbench.core import load_patterns


def read(layer):
    t, steps = layer.get("trace"), layer.get("traced_steps", 0)
    if t is None or steps <= 0:
        return None
    rx = [re.compile(p) for p in load_patterns("comm_exposed_ms.train")]
    comm = sorted((s, e) for n, s, e in t.kernels if any(r.search(n) for r in rx))
    if not comm:
        return None
    other = sorted((s, e) for n, s, e in t.kernels if not any(r.search(n) for r in rx))
    exposed = 0.0
    for s, e in comm:
        covered, cur = 0.0, s
        for a, b in other:
            if b <= cur or a >= e:
                continue
            lo = max(a, cur)
            if b > lo:
                covered += min(b, e) - lo
                cur = min(b, e)
            if cur >= e:
                break
        exposed += (e - s) - covered
    return exposed / 1e3 / steps
