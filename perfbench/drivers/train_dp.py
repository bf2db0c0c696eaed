"""Data-parallel training driver: the training driver's run on `world`
processes, one a card, formed as torchrun forms them (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT on a free local port) and started by
this process, which waits for every one of them.

Every rank reads the same shards (written once, here, before the ranks
start) through its own share and loader seed, as the trainer splits them.
The window closes on every rank at the same step: each step's `on_step`
takes rank 0's "closed" flag through an all-reduce on the host (a gloo
group of the harness's own, so that no collective of the harness runs on
the cards or shows in the Distributed layer's kernels).  Rank 0 profiles, reads the
per-layer metrics, and after the window runs the reference on the global
batch of the warm-up steps (every rank's rows, stacked in rank order);
the others write their rows and their peak memory and end.

    python3 -m perfbench.drivers.train_dp JOB_JSON   (one rank)
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench import core, weights
from perfbench.drivers import train

RANK_TIMEOUT_S = 900
TRAFFIC_KEYS = train.TRAFFIC_KEYS


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(ctx) -> core.RunResult:
    """The parent: shards, the ranks, their results."""
    world = ctx.traffic["world"]
    tmp = tempfile.mkdtemp(prefix="perfbench-dp-")
    procs = []
    try:
        pattern, _ = train.write_shards(os.path.join(tmp, "shards"), ctx.config, ctx.traffic,
                                        weights.sub_seed(ctx.seed, 5))
        job = {"workload": ctx.workload, "seed": ctx.seed, "seconds": ctx.seconds,
               "trace": ctx.trace, "tmp": tmp, "pattern": pattern, "started": ctx.started,
               "device": ctx.device.type,
               "overrides": {"config": ctx.config, "traffic": ctx.traffic}}
        env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(_free_port()),
                   OMP_NUM_THREADS=str(max(1, (os.cpu_count() or world) // world)),
                   PYTHONPATH=os.pathsep.join([core.ROOT, os.environ.get("PYTHONPATH", "")]))
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", getattr(ctx, "rank_module", __name__), json.dumps(job)],
                cwd=core.ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
        deadline = time.time() + RANK_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"rank exit codes {codes}")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result-{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    res, readings = results[0]["result"], results[0]["readings"]
    res.memory_peak_bytes = max(x["peak"] for x in results)
    res.e2e["peak_mem_gib"] = res.memory_peak_bytes / 2 ** 30
    res.forbidden = sorted({m for x in results for m in x["forbidden"]})
    ctx.readings = readings
    return res


def rank_main(job: dict) -> None:
    """One rank: the trainer under the recorder until the window closes."""
    from perfbench import run as runner
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = (torch.device("cuda", int(os.environ["LOCAL_RANK"])) if job["device"] == "cuda"
           else torch.device("cpu"))
    ctx = runner.context(job["workload"], job["seed"], job["seconds"], job["trace"], dev,
                         started=job["started"], **job["overrides"])
    rec = _AgreedRecorder(ctx, weights.sub_seed(ctx.seed, 1), rank)
    train.train_in_process(ctx, rec, job["tmp"], job["pattern"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tmp = job["tmp"]
    out = {"peak": peak, "forbidden": core.forbidden_modules()}
    if rank != 0:
        _dump(rec.batches, os.path.join(tmp, f"rows-{rank}.pkl"))
        rec.free()
    else:
        rows = [rec.batches]
        for r in range(1, world):
            path = os.path.join(tmp, f"rows-{r}.pkl")
            deadline = time.time() + 300
            while not os.path.exists(path):
                if time.time() > deadline:
                    raise RuntimeError(f"rank {r} wrote no rows")
                time.sleep(0.2)
            with open(path, "rb") as f:
                rows.append(pickle.load(f))
        batches = [{m: {k: np.concatenate([rk[s][m][k] for rk in rows]) for k in rows[0][s][m]}
                    for m in rows[0][s]} for s in range(len(rows[0]))]
        samples = train.by_key(train.shard_samples(ctx.config, ctx.traffic,
                                                   weights.sub_seed(ctx.seed, 5)))
        out["result"] = train.finish(ctx, rec, samples, peak, chips=world, world=world,
                                     batches=batches)
        out["readings"] = ctx.readings
    _dump(out, os.path.join(tmp, f"result-{rank}.pkl"))


def _dump(obj, path: str) -> None:
    """Pickle `obj` to `path` whole: written aside, then renamed."""
    with open(path + ".part", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".part", path)


class _AgreedRecorder(train.Recorder):
    """A recorder whose window closes on every rank at the same step."""

    flag_group = None

    def on_step(self, step, values, seconds):
        import torch.distributed as dist
        if self.flag_group is None:  # every rank's first step: a collective call
            self.flag_group = dist.new_group(backend="gloo")
        try:
            super().on_step(step, values, seconds)
            closed = False
        except train.WindowClosed:
            closed = True
        if len(self.losses) < self.warmup or self.window.start == 0.0:
            return
        # rank 0 decides: it alone knows when its profiled stretch is done
        flag = torch.tensor([1 if closed and self.rank == 0 else 0])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.flag_group)
        if flag.item() > 0:
            if self.window.end == 0.0:  # this rank's window opened after rank 0's
                self.window.end = self.window.marks[-1]
            raise train.WindowClosed


if __name__ == "__main__":
    rank_main(json.loads(sys.argv[1]))
