#!/usr/bin/env python3
"""Run one benchmark cell once, from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by name: perfbench/cells/<cell>.json names its
configuration (configs/), traffic (traffic/), chips and driver (drivers/);
its limits are limits/<cell>.json; BENCHMARK.json lists the metrics, each
read by metrics/<metric>.py.  With --trace 0 the last line of standard
output holds the cell's end-to-end metrics, with --trace 1 its per-layer
metrics from a profiled stretch of the window.  The numbers compared with
the reference are printed beside their limits as the last lines of
standard error and under "checks", the last key of the result.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import core  # noqa: E402


def benchmark() -> dict:
    with open(os.path.join(core.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_for(bench: dict, workload: str, trace: bool):
    """(name, unit) of the metrics this cell reports in this kind of run."""
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if workload in m.get("workloads", [workload]):
            out.append((m["name"], m["unit"]))
    return out


def read_metric(name: str, layer: dict):
    path = os.path.join(core.BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(layer)


def context(workload: str, seed: int, seconds: float, trace: bool, device, **over):
    """Everything a driver takes; `over` replaces any field (tests: small
    configurations on the CPU)."""
    cell = core.load_json("cells", f"{workload}.json")
    ctx = SimpleNamespace(
        workload=workload, cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
        config=core.load_json("configs", f"{cell['config']}.json"),
        traffic=core.load_json("traffic", f"{cell['traffic']}.json"),
        limits=core.load_json("limits", f"{workload}.json"), peaks=core.peaks(),
        started=core.process_start(), readings={})
    for k, v in over.items():
        setattr(ctx, k, v)
    return ctx


def check_traffic(traffic: dict, driver) -> None:
    """Refuse a traffic file with a key its driver does not read: a knob
    that changed nothing would make a new cell the same as an old one."""
    unread = sorted(set(traffic) - set(driver.TRAFFIC_KEYS))
    if unread:
        raise ValueError(f"{driver.__name__} reads no traffic key {', '.join(unread)}")


def result_line(ctx, res: core.RunResult, names, device_kind: str) -> dict:
    """The contract's last line; `checks` comes last."""
    if ctx.trace:
        values = {n: read_metric(n, res.layer) for n, _ in names}
    else:
        values = {n: res.e2e.get(n) for n, _ in names}
    metrics = {n: {"value": values[n], "unit": u} for n, u in names if values[n] is not None}
    device = {"platform": "gpu", "kind": device_kind, "count": res.count,
              "memory_peak_bytes": int(res.memory_peak_bytes)}
    if ctx.trace:
        device.update(busy_s=res.busy_s, window_s=res.window_s)
    line = {"correct": all(c.ok for c in res.checks), "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": device}
    if ctx.trace and res.breakdown:
        line["breakdown"] = res.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in res.checks}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = benchmark()
    if args.workload not in {w["name"] for w in bench["workloads"]}:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    core.fixed_cache_dirs()
    import torch
    chips = core.load_json("cells", f"{args.workload}.json")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    ctx = context(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0))
    driver = importlib.import_module(f"perfbench.drivers.{ctx.cell['driver']}")
    check_traffic(ctx.traffic, driver)
    res = driver.run(ctx)
    names = metrics_for(bench, args.workload, bool(args.trace))
    line = result_line(ctx, res, names, torch.cuda.get_device_name(0))
    found = core.forbidden_modules() + list(getattr(res, "forbidden", []))
    if found:
        print(f"the run loaded {', '.join(sorted(set(found)))}: no result", file=sys.stderr)
        return 4
    for k, v in sorted(ctx.readings.items()):
        print(f"reading {k} {v!r}", file=sys.stderr)
    for c in res.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
