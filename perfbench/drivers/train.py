"""Training driver: pretraining through the program's own entry point,
`cli/run_training.main`, on aligned token shards written at set-up from the
seed, read by the program's loader with forked workers.

Set-up writes the shards and the data config under the run's TMPDIR,
builds the trainer (the model's weights: the benchmark's seeded set, made
on the card, in place of the trainer's own draw), and runs the warm-up
steps through the trainer's own loop; those steps' batches, losses, the
first gradient (from Adam's state) and the change after the last of them
are kept for the check.  The window opens at the last warm-up step's
`on_step` and closes at the first step that ends `seconds` later; a step's
interval runs from one `on_step` to the next, so the data fetch counts.
After the window: the peak memory, the program freed, and the reference's
steps.
"""
from __future__ import annotations

import gc
import io
import json
import os
import shutil
import tarfile
import tempfile
import time

import numpy as np
import torch

from perfbench import core, weights
from perfbench.work import WorkCounter


# the traffic keys this driver reads; run.py refuses a traffic file with others
TRAFFIC_KEYS = ("batch", "world", "num_input_tokens", "num_target_tokens", "loss_type", "blr",
                "opt_betas", "weight_decay", "clip_grad", "lr_schedule", "num_workers",
                "warmup_steps", "shards", "samples_per_shard", "wds_n_repeats",
                "wds_shuffle_buffer_tar", "alphas", "dataset", "shard_dirs", "traced_steps",
                "trace_after")


class WindowClosed(Exception):
    """Raised from on_step to leave the trainer's loop."""


def shard_samples(config, tr, seed: int):
    """The shards' samples, shard by shard: lists of {modality: tokens}."""
    rng = np.random.default_rng(seed)
    return [[{m: rng.integers(0, config["modalities"][m]["vocab_size"],
                              config["modalities"][m]["grid"]).astype(np.int32)
              for m in tr["shard_dirs"]} for _ in range(tr["samples_per_shard"])]
            for _ in range(tr["shards"])]


def by_key(shards):
    """{tok_rgb bytes: sample}, for judging the loader's rows."""
    return {smp["tok_rgb"].reshape(-1).tobytes(): smp for shard in shards for smp in shard}


def write_shards(root: str, config, tr, seed: int):
    """Aligned shards root/<dir>/bench/shard-NNNNNN.tar, one npz member per
    sample and modality, as prepare_aligned_shards.py writes them.  Returns
    (the data_path pattern, {tok_rgb bytes: sample})."""
    mods = tr["shard_dirs"]
    shards = shard_samples(config, tr, seed)
    for i, batch in enumerate(shards):
        for m, sub in mods.items():
            d = os.path.join(root, sub, "bench")
            os.makedirs(d, exist_ok=True)
            with tarfile.open(os.path.join(d, f"shard-{i:06d}.tar"), "w") as tar:
                for j, smp in enumerate(batch):
                    buf = io.BytesIO()
                    np.savez(buf, smp[m])
                    info = tarfile.TarInfo(f"bench_{i:06d}_{j:04d}.npz")
                    info.size = buf.tell()
                    buf.seek(0)
                    tar.addfile(info, buf)
    subs = ",".join(mods.values())
    return (f"{root}/[{subs}]/bench/shard-{{000000..{tr['shards'] - 1:06d}}}.tar",
            by_key(shards))


def trainer_argv(ctx, tmp: str, pattern: str):
    tr = ctx.traffic
    alphas = os.path.join(tmp, "alphas.json")
    with open(alphas, "w") as f:
        json.dump(tr["alphas"], f)
    data = {"train": {"datasets": {"bench": {
        **tr["dataset"], "data_path": pattern, "alphas_config": alphas,
        "wds_n_repeats": tr["wds_n_repeats"],
        "wds_shuffle_buffer_tar": tr["wds_shuffle_buffer_tar"]}}, "weights": [1.0]}}
    data_path = os.path.join(tmp, "data.json")
    with open(data_path, "w") as f:
        json.dump(data, f)
    return ["--data_config", data_path, "--model", ctx.config["model"]["registry_name"],
            "--batch_size", str(tr["batch"]), "--num_input_tokens", str(tr["num_input_tokens"]),
            "--num_target_tokens", str(tr["num_target_tokens"]), "--loss_type", tr["loss_type"],
            "--blr", str(tr["blr"]), "--opt_betas", *map(str, tr["opt_betas"]),
            "--weight_decay", str(tr["weight_decay"]), "--clip_grad", str(tr["clip_grad"]),
            "--lr_schedule", tr["lr_schedule"], "--epochs", "1",
            "--epoch_size", str(tr["batch"] * tr["world"] * 1_000_000),
            "--num_workers", str(tr["num_workers"]), "--eval_freq", "0", "--no_fixed_eval",
            "--no_auto_resume", "--async_save", "false", "--save_ckpt_freq", "1000000",
            "--print_freq", "1000000", "--seed", str(ctx.seed), "--output_dir",
            os.path.join(tmp, "out"), "--device", ctx.device.type]


class Recorder:
    """What the trainer hands out, kept for the window and the check."""

    def __init__(self, ctx, model_seed: int, rank: int = 0):
        self.ctx, self.model_seed, self.rank = ctx, model_seed, rank
        tr = ctx.traffic
        self.warmup = tr["warmup_steps"]
        self.model = self.optimizer = self.counter = None
        self.calls = 0
        self.batches, self.losses = [], []
        self.grad1 = self.change = None
        self.window = core.Window(ctx.seconds)
        self.opened_wall = 0.0
        self.step_s, self.window_steps = [], 0
        self.prof, self.stopped, self.t_prof, self.stretch_s = None, None, 0.0, 0.0
        self.after_stop = None
        self.traced = set()
        self.fetch_s, self.to_device_s = [], []
        self.fed_inputs, self.fed_targets, self.fed_mods = [], [], []

    # the trainer's create_model, with the benchmark's weights
    def wrap_create(self, create):
        def create_model(*args, **kwargs):
            model = create(*args, **kwargs)

            def init_random_(generator):
                weights.fill_module_(model.named_parameters(), self.model_seed, "egom2p")
                return model

            model.init_random_ = init_random_
            return model
        return create_model

    def wrap_make_step(self, make):
        def make_train_step(model, optimizer, *args, **kwargs):
            self.model, self.optimizer = model, optimizer
            self.counter = WorkCounter(model, self.ctx.peaks)
            inner = make(model, optimizer, *args, **kwargs)

            def train_step(batch, shuffle=None):
                with torch.profiler.record_function("perfbench:train_step"):
                    return step(batch, shuffle)

            def step(batch, shuffle):
                k = self.calls
                self.calls += 1
                self.counter.tag = k
                if k < self.warmup:
                    self.batches.append({m: {n: v.cpu().numpy() for n, v in d.items()}
                                         for m, d in batch.items()})
                out = inner(batch, shuffle)
                if k == 0:
                    self.grad1 = self._grad1()
                if k == self.warmup - 1:
                    self.change = self._change()
                return out
            return train_step
        return make_train_step

    @torch.no_grad()
    def _grad1(self):
        b1 = self.ctx.traffic["opt_betas"][0]
        state = self.optimizer.adamw.state
        return {n: float(state[p]["exp_avg"].norm()) / (1 - b1) if p in state else 0.0
                for n, p in self.model.named_parameters()}

    @torch.no_grad()
    def _change(self):
        named = dict(self.model.named_parameters())
        start = weights.draw({n: tuple(p.shape) for n, p in named.items()}, self.model_seed,
                             "egom2p", next(iter(named.values())).device)
        return {n: float((p - start.pop(n)).norm()) for n, p in named.items()}

    def on_step(self, step, values, seconds):
        ctx, tr = self.ctx, self.ctx.traffic
        if len(self.losses) < self.warmup:
            self.losses.append({k: v for k, v in values.items() if k.startswith("loss")})
            if len(self.losses) == self.warmup:
                self.counter.active = True
                if ctx.device.type == "cuda":
                    torch.cuda.synchronize(ctx.device)
                    torch.cuda.reset_peak_memory_stats(ctx.device)
                self.opened_wall = time.time()
                self.window.open()
            return
        closed = self.window.mark()
        self.window_steps += 1
        self.step_s.append(seconds)
        n = self.window_steps
        if self.prof is not None:
            self.traced.add(step)
            if n == tr["trace_after"] + tr["traced_steps"]:
                # the events are read after the window; the stop's own time
                # falls into the next step, which no per-layer metric reads
                self.stretch_s = time.perf_counter() - self.t_prof
                self.prof.stop()
                self.stopped, self.prof = self.prof, None
                self.after_stop = step + 1
        elif ctx.trace and self.stopped is None and n == tr["trace_after"] and self.rank == 0:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                              if ctx.device.type == "cuda" else [])
            self.prof = profile(activities=acts)
            self.prof.start()
            self.t_prof = time.perf_counter()
        if closed and self.prof is None and (not ctx.trace or self.stopped is not None
                                             or self.rank != 0):
            raise WindowClosed

    def count_fed(self, batch) -> None:
        """Each row's live inputs and targets a modality, (rows, mods) in
        sorted modality order, of a batch the loader handed out."""
        mods = sorted(batch)
        self.fed_mods = mods
        self.fed_inputs.append(np.stack([(~np.asarray(batch[m]["input_mask"])).sum(axis=1)
                                         for m in mods], axis=1))
        self.fed_targets.append(np.stack([(~np.asarray(batch[m]["target_mask"])).sum(axis=1)
                                          for m in mods], axis=1))

    def program_readings(self):
        return {"losses": self.losses, "grad1": self.grad1, "change": self.change}

    @property
    def trace(self):
        if self.stopped is not None and not isinstance(self.stopped, core.Trace):
            self.stopped = core.Trace.from_profile(self.stopped, self.stretch_s)
        return self.stopped

    def layer(self, chips: int, world: int):
        """The per-layer context over the window's clean steps (neither
        profiled nor holding the profiler's stop); FLOPs scaled to the
        global batch by the world size."""
        tags = [self.warmup + i for i in range(self.window_steps)]
        clean = [i for i, t in enumerate(tags) if t not in self.traced and t != self.after_stop]
        work_u = self.counter.reduce({tags[i] for i in clean})
        iv = [self.window.intervals[i] for i in clean]
        return {"intervals": iv, "step_s": [self.step_s[i] for i in clean],
                "trace": self.trace,
                "work": self.counter.reduce(self.traced) if self.traced else {},
                "traced_steps": len(self.traced), "chips": chips,
                "untraced_s": sum(iv), "untraced_flops": work_u["model_flops"] * world,
                "traced_units": len(self.traced), "untraced_unit_s": sum(iv) / max(len(iv), 1),
                "peak_flops": self.ctx.peaks["bf16_flops_per_s"]}

    def free(self):
        if self.counter is not None:
            self.counter.close()
        self.model = self.optimizer = self.counter = None


def _timed(fn, into, span: str):
    """`fn` under the span `span`, its seconds appended to `into` (the
    harness's spans around the loop's fetch and its copy to the device)."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(span):
                return fn(*args, **kwargs)
        finally:
            into.append(time.perf_counter() - t0)
    return timed


def _fetched(fetch, rec: Recorder):
    """The loader's fetch, timed as `_timed` does; each batch's live tokens
    counted after its time is taken."""
    timed = _timed(fetch, rec.fetch_s, "perfbench:fetch")

    def fetched(*args, **kwargs):
        batch = timed(*args, **kwargs)
        rec.count_fed(batch)
        return batch
    return fetched


def train_in_process(ctx, rec: Recorder, tmp: str, pattern: str):
    """run_training.main under the recorder's patches, until the window closes."""
    from egom2p_torch.cli import run_training
    from egom2p_torch.data import loader
    from egom2p_torch.models import egom2p as egom2p_models
    from egom2p_torch.train import egom2p_train

    args = run_training.get_args(trainer_argv(ctx, tmp, pattern))
    saved = (egom2p_models.create_model, egom2p_train.make_train_step, loader.batch_to_device,
             loader.LoaderIterator.__next__)
    egom2p_models.create_model = rec.wrap_create(saved[0])
    egom2p_train.make_train_step = rec.wrap_make_step(saved[1])
    loader.batch_to_device = _timed(saved[2], rec.to_device_s, "perfbench:to_device")
    loader.LoaderIterator.__next__ = _fetched(saved[3], rec)
    try:
        run_training.main(args, on_step=rec.on_step)
    except WindowClosed:
        pass
    finally:
        (egom2p_models.create_model, egom2p_train.make_train_step, loader.batch_to_device,
         loader.LoaderIterator.__next__) = saved
    if rec.window.end == 0.0:
        raise RuntimeError("the trainer stopped before the window closed")


def run(ctx) -> core.RunResult:
    tr, dev = ctx.traffic, ctx.device
    if tr["world"] != 1:
        raise ValueError("the train driver runs one process; a traffic over "
                         f"{tr['world']} takes the train_dp driver")
    model_seed = weights.sub_seed(ctx.seed, 1)
    tmp = tempfile.mkdtemp(prefix="perfbench-train-")
    try:
        pattern, samples = write_shards(os.path.join(tmp, "shards"), ctx.config, tr,
                                        weights.sub_seed(ctx.seed, 5))
        rec = Recorder(ctx, model_seed)
        train_in_process(ctx, rec, tmp, pattern)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return finish(ctx, rec, samples, peak, chips=1, world=1, batches=rec.batches)


def finish(ctx, rec: Recorder, samples, peak: int, chips: int, world: int,
           batches) -> core.RunResult:
    """The end-to-end readings, the program freed, and the check."""
    from perfbench.reference import masking, train_check
    tr = ctx.traffic
    global_batch = tr["batch"] * world
    tokens = global_batch * (tr["num_input_tokens"] + tr["num_target_tokens"])
    steps = rec.window_steps
    e2e = {"train_tokens_per_s": tokens * steps / rec.window.length,
           "train_step_ms_p90": 1e3 * core.percentile(rec.window.intervals, 90),
           "peak_mem_gib": peak / 2 ** 30, "setup_s": rec.opened_wall - ctx.started}
    layer = rec.layer(chips, world)
    trace = rec.trace
    t_check = time.perf_counter()
    program = rec.program_readings()
    rec.free()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    n_in, n_tgt = tr["num_input_tokens"], tr["num_target_tokens"]
    bad = sum(train_check.judge_rows(b, samples, n_in, n_tgt) for b in batches)
    fed_in, fed_tgt = np.concatenate(rec.fed_inputs), np.concatenate(rec.fed_targets)
    token_counts = {m: int(np.prod(ctx.config["modalities"][m]["grid"])) for m in rec.fed_mods}
    fed_bad = train_check.judge_budgets(fed_in, fed_tgt, list(token_counts.values()), n_in, n_tgt)
    live = masking.live_count_z(fed_in.sum(axis=1), fed_tgt.sum(axis=1), tr["alphas"],
                                token_counts, n_in, n_tgt, weights.sub_seed(ctx.seed, 6))
    ref = train_check.reference_steps(ctx.config, tr, weights.sub_seed(ctx.seed, 1), batches,
                                      ctx.device, global_batch)
    out = train_check.compare(program, ref, bad + fed_bad)
    out.update(live, fed_rows_bad=float(fed_bad), warmup_rows_bad=float(bad))
    n = rec.window_steps
    out_spans = {}
    for name, xs in (("fetch_ms", rec.fetch_s[-n:]), ("to_device_ms", rec.to_device_s[-n:])):
        if xs:
            out_spans.update({f"{name}_mean": 1e3 * float(np.mean(xs)),
                              f"{name}_p50": 1e3 * float(np.median(xs)),
                              f"{name}_max": 1e3 * float(np.max(xs))})
    ctx.readings = {**out, **out_spans,
                    **{f"program_{k}_{i}": v for i, s in enumerate(program["losses"])
                       for k, v in s.items()},
                    **{f"reference_{k}_{i}": v for i, s in enumerate(ref["losses"])
                       for k, v in s.items()}}
    ctx.readings["check_s"] = time.perf_counter() - t_check
    if trace is not None:
        ctx.readings.update({f"work_{k}": v for k, v in layer["work"].items()})
        ctx.readings["attn_kernel_s"] = trace.kernel_seconds(
            core.load_patterns("attn_roofline.train"))
    lim = ctx.limits
    checks = [core.Check(n, out[n], lim[n])
              for n in ("masked_rows_bad", "live_count_z", "loss_gap", "grad1_gap", "change_gap")]
    return core.RunResult(
        e2e=e2e, layer=layer, checks=checks, attempted=steps, failed=0,
        memory_peak_bytes=peak, count=chips,
        busy_s=trace.busy_us() / 1e6 if trace is not None else None,
        window_s=trace.wall_s if trace is not None else None,
        breakdown=({"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
                   if trace is not None else None))
