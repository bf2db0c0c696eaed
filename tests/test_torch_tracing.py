"""The port's spans and counters (egom2p_torch/core/tracing.py), where the
program opens them, the benchmark's readers of them, and the trainers'
`data:` meter.

CPU tests at small sizes; the two tests marked `gpu` need a CUDA card and
skip elsewhere.  This file imports no JAX, so on the card's machine:

    python -m pytest tests/test_torch_tracing.py -m gpu --noconftest -q
"""
import re
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from egom2p_torch.core import tracing

NAME = "egom2p_tiny_6e_6d_swiglu_nobias"
MODS4 = ("tok_cam", "tok_depth", "tok_gaze", "tok_rgb")
STEP = ["egom2p.roar.encoder", "egom2p.roar.encoder", "egom2p.roar.decoder",
        "egom2p.roar.decoder", "egom2p.roar.head", "egom2p.roar.update"]
TRAIN_UNIT = ["egom2p.data.fetch", "egom2p.data.to_device", "egom2p.train.step",
              "egom2p.train.forward", "egom2p.train.backward", "egom2p.train.optimizer"]
REGISTRY_READERS = ["roar_encoder_ms.serve", "roar_decoder_ms.serve", "roar_head_ms.serve",
                    "fwd_ms.train", "bwd_ms.train", "optim_ms.train", "live_share.train",
                    "live_in_max_share.train", "live_tgt_max_share.train",
                    "device_allocs.train", "ce_row_share.train"]
TRACE_READERS = ["fetch_ms.train", "to_device_ms.train"]


@pytest.fixture(autouse=True)
def fresh_registry():
    tracing.reset()
    yield
    tracing.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _spans_in(prof):
    """The program's spans in a profile (their host ranges: on CUDA the
    device's timeline holds an annotation of each too), in the order they
    opened."""
    return sorted((e for e in prof.events() if e.name.startswith("egom2p.")
                   and e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.time_range.start)


def _names(prof):
    return [e.name for e in _spans_in(prof)]


# ----------------------------------------------------------------- module
def test_off_hands_out_the_shared_null_context_and_records_nothing():
    assert not torch.autograd._profiler_enabled()
    a, b = tracing.span("egom2p.x"), tracing.span("egom2p.y", unit=True)
    assert a is b
    with a:
        tracing.count("train.rows", 3)      # counters count profiler or not
    assert tracing.snapshot() == {"units": 0, "counters": {"train.rows": 3}}


def test_on_spans_sit_in_the_profile_with_their_parents_and_units():
    with _cpu_profile() as prof:
        with tracing.span("egom2p.before"):
            pass
        with tracing.span("egom2p.outer", unit=True):
            with tracing.span("egom2p.inner"):
                time.sleep(0.02)
            with tracing.span("egom2p.inner"):
                time.sleep(0.01)
            time.sleep(0.01)
        with tracing.span("egom2p.after"):
            tracing.count("c", 2)
        with tracing.span("egom2p.outer", unit=True):
            tracing.count("c", 3)
    assert _names(prof) == ["egom2p.before", "egom2p.outer", "egom2p.inner", "egom2p.inner",
                            "egom2p.after", "egom2p.outer"]
    inner = [e for e in _spans_in(prof) if e.name == "egom2p.inner"]
    assert all(e.cpu_parent is not None and e.cpu_parent.name == "egom2p.outer" for e in inner)
    assert tracing.snapshot() == {"units": 2, "counters": {"c": 5}}
    s = tracing.spans(*tracing.events(prof))
    assert s["egom2p.inner"]["calls"] == 2 and s["egom2p.outer"]["calls"] == 2
    assert s["egom2p.inner"]["host_ms"] >= 30.0
    assert s["egom2p.outer"]["host_ms"] >= s["egom2p.inner"]["host_ms"] + 10.0
    assert s["egom2p.inner"]["device_ms"] is None          # no kernel: nothing to pair
    table = tracing.table(prof)
    assert re.search(r"egom2p\.inner\s+2\s", table) and "units 2" in table


def _launch(t):
    return ("cudaLaunchKernel", t, t + 2.0)


# a span over launches at 10 and 20, one over 30 (from another thread: only
# the time counts), and the device behind the host: the kernels run late,
# with idle between them that no span counts
HOST = [("egom2p.a", 5.0, 25.0), _launch(10.0), ("aten::mm", 19.0, 23.0), _launch(20.0),
        ("egom2p.b", 28.0, 40.0), ("cuLaunchKernel", 30.0, 31.0), ("cudaEventRecord", 32, 33),
        ("cudaMemcpyAsync", 50.0, 52.0)]
KERNELS = [("k1", 100.0, 1100.0), ("k2", 1200.0, 1500.0), ("triton_k3", 4000.0, 4050.0),
           ("Memcpy HtoD", 4100.0, 4110.0)]


def test_spans_take_the_time_of_the_kernels_their_launches_started():
    s = tracing.spans(HOST, KERNELS)
    empty_fill = tracing.spans(HOST + [("cudaMemsetAsync", 21.0, 22.0)], KERNELS)
    assert empty_fill == s                                 # a fill of nothing runs nothing
    assert s["egom2p.a"] == {"calls": 1, "host_ms": 0.02, "device_ms": pytest.approx(1.3)}
    assert s["egom2p.b"]["device_ms"] == pytest.approx(0.05)
    nested = tracing.spans(HOST + [("egom2p.all", 0.0, 60.0)], KERNELS)["egom2p.all"]
    assert nested["device_ms"] == pytest.approx(1.36)     # busy, not the 4010 us wall


@pytest.mark.parametrize("kernels", [KERNELS[:2] + KERNELS[3:], KERNELS + [("k5", 5000.0, 5001.0)],
                                     KERNELS[:3] + [("Memset (Device)", 4100.0, 4101.0)], []])
def test_spans_give_no_device_time_where_launches_and_kernels_do_not_pair(kernels):
    s = tracing.spans(HOST, kernels)
    assert s["egom2p.a"]["device_ms"] is None and s["egom2p.a"]["calls"] == 1


# ----------------------------------------------------------------- serving
def test_roar_generate_opens_encoder_decoder_head_update_each_step(monkeypatch):
    from egom2p_torch.cli import eval_common
    from egom2p_torch.generate.sampler import GenerationSampler
    from egom2p_torch.models.egom2p import create_model
    from perfbench.tests import small

    small.patch_program(monkeypatch)
    torch.manual_seed(0)
    model = create_model(small.TINY["registry_name"], in_domains=list(MODS4),
                         out_domains=list(MODS4)).eval()
    schedule = eval_common.roar_schedule("tok_rgb", "tok_depth", 3, 0.01)
    n = int(np.prod(small.GRID))
    cond = np.random.default_rng(0).integers(0, 64000, (2, n)).astype(np.int32)
    with _cpu_profile() as prof:
        out, _ = eval_common.run_tokens(cond, GenerationSampler(model), schedule, "tok_rgb",
                                        "tok_depth", seed=5)
    assert out["tok_depth"]["tensor"].shape == (2, n)
    assert _names(prof) == ["egom2p.generate"] + STEP * 3
    assert all(e.cpu_parent.name == "egom2p.generate" for e in _spans_in(prof)[1:])


# ---------------------------------------------------------------- training
def _train_args(tmp_path, *more):
    from egom2p_torch.cli import run_training
    return run_training.get_args(
        ["--synthetic_data", "--scaled_modalities", "--model", NAME, "--num_input_tokens", "32",
         "--num_target_tokens", "32", "--batch_size", "2", "--epochs", "1", "--epoch_size", "4",
         "--num_workers", "0", "--device", "cpu", "--print_freq", "1",
         "--output_dir", str(tmp_path), "--no_auto_resume", *more])


def test_training_opens_fetch_copy_step_forward_backward_optimizer_each_step(
        tmp_path, monkeypatch, capsys):
    """A profiled run of two steps (--profile): each step one unit, opened
    by its fetch, with the step's forward, backward and optimizer inside the
    step span; the live counters are a numpy count of the fetched batches'
    masks; the operator's table is printed."""
    from egom2p_torch.cli import run_training
    from egom2p_torch.data import loader

    fetched, profs = [], []
    real, start = loader.batch_to_device, run_training._start_profile

    def keep(raw, device):
        fetched.append(raw)
        return real(raw, device)

    def started(*args):
        profs.append(start(*args))
        return profs[-1]

    monkeypatch.setattr(loader, "batch_to_device", keep)
    monkeypatch.setattr(run_training, "_start_profile", started)
    run_training.main(_train_args(tmp_path, "--profile"))
    assert _names(profs[0]) == TRAIN_UNIT * 2
    parents = [e.cpu_parent.name if e.cpu_parent else None for e in _spans_in(profs[0])]
    assert parents[:6] == [None, None, None] + ["egom2p.train.step"] * 3
    snap = tracing.snapshot()
    assert snap["units"] == 2
    steps = fetched[:2]          # the evaluation's batches follow
    live_in = [sum((~d["input_mask"]).sum(axis=1) for d in raw.values()) for raw in steps]
    live_tgt = [sum((~d["target_mask"]).sum(axis=1) for d in raw.values()) for raw in steps]
    assert snap["counters"] == {
        "train.batches": 2, "train.rows": 4,
        "train.live_inputs": sum(int(x.sum()) for x in live_in),
        "train.live_targets": sum(int(x.sum()) for x in live_tgt),
        "train.live_inputs_max": sum(int(x.max()) for x in live_in),
        "train.live_targets_max": sum(int(x.max()) for x in live_tgt),
        "train.input_slots": 2 * 2 * 32, "train.target_slots": 2 * 2 * 32,
        # each of the 4 heads over its own rows: the live targets
        "train.ce_rows": sum(int(x.sum()) for x in live_tgt),
        "train.ce_row_slots": 2 * 4 * 2 * 32}
    out = capsys.readouterr().out
    assert "profile trace ->" in out and re.search(r"egom2p\.train\.backward\s+2\s", out)


def test_data_meter_shows_a_slow_loader(tmp_path, monkeypatch, capsys):
    """The `data:` meter times the loop's fetch and copy: a loader that
    sleeps 0.3 s a batch shows there."""
    from egom2p_torch.cli import run_training
    from egom2p_torch.data import loader

    real = loader.LoaderIterator.__next__

    def slow(self):
        time.sleep(0.3)
        return real(self)

    monkeypatch.setattr(loader.LoaderIterator, "__next__", slow)
    run_training.main(_train_args(tmp_path))
    meters = re.findall(r"data: ([0-9.]+) \(([0-9.]+)\)", capsys.readouterr().out)
    assert len(meters) == 2
    assert all(float(median) >= 0.3 for median, _ in meters)


# ----------------------------------------------------------------- readers
def _layer(trace, **kw):
    return {"trace": trace, "traced_units": 2, **kw}


@pytest.mark.parametrize("name", REGISTRY_READERS + TRACE_READERS)
def test_reader_returns_nothing_on_an_empty_registry_or_without_a_trace(name):
    from perfbench import core
    from perfbench.run import read_metric

    empty = core.Trace([("k", 0.0, 10.0)], [("aten::mm", 0.0, 5.0)], wall_s=0.1)
    assert read_metric(name, _layer(empty)) is None
    with _cpu_profile():
        with tracing.span("egom2p.data.fetch", unit=True):
            pass
        for k in ("train.batches", "train.rows", "train.live_inputs", "train.live_targets",
                  "train.live_inputs_max", "train.live_targets_max", "train.input_slots",
                  "train.target_slots", "device.allocs", "train.ce_rows",
                  "train.ce_row_slots"):
            tracing.count(k, 2)
    assert read_metric(name, _layer(None)) is None


def test_readers_divide_the_registry_by_the_units(monkeypatch):
    from perfbench import core
    from perfbench.run import read_metric

    counters = {"train.batches": 2, "train.rows": 16, "train.live_inputs": 8000,
                "train.live_targets": 8384, "train.live_inputs_max": 2048,
                "train.live_targets_max": 1024, "train.input_slots": 16 * 1024,
                "train.target_slots": 16 * 1024, "device.allocs": 6,
                "train.ce_rows": 8384, "train.ce_row_slots": 4 * 16 * 1024}
    monkeypatch.setattr(tracing, "snapshot", lambda: {"units": 2, "counters": counters})
    host = [("egom2p.roar.encoder", 0.0, 100.0), _launch(10.0), _launch(20.0),
            ("egom2p.train.optimizer", 200.0, 300.0), _launch(250.0),
            ("egom2p.data.fetch", 0.0, 3000.0), ("egom2p.data.fetch", 5000.0, 6000.0)]
    kernels = [("k1", 100.0, 200100.0), ("k2", 200100.0, 300100.0), ("k3", 300200.0, 330200.0)]
    layer = _layer(core.Trace(kernels, host, wall_s=0.4))
    assert read_metric("roar_encoder_ms.serve", layer) == pytest.approx(150.0)
    assert read_metric("optim_ms.train", layer) == pytest.approx(15.0)
    assert read_metric("fwd_ms.train", layer) is None
    assert read_metric("live_share.train", layer) == pytest.approx(50.0)
    assert read_metric("live_in_max_share.train", layer) == pytest.approx(100.0)
    assert read_metric("live_tgt_max_share.train", layer) == pytest.approx(50.0)
    assert read_metric("device_allocs.train", layer) == 3.0
    assert read_metric("ce_row_share.train", layer) == pytest.approx(12.79296875)
    assert read_metric("fetch_ms.train", layer) == 2.0
    assert read_metric("to_device_ms.train", layer) is None


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cuda_profile():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _check_profile(prof):
    """No span is counted as a kernel; each span's device time is the one
    the profiler's own pairing of launch and kernel (the correlation id)
    gives; the allocator's calls the registry counted are the profile's
    cudaMalloc calls inside the spans."""
    from perfbench import core
    trace = core.Trace.from_profile(prof, 1.0)
    assert trace.kernels
    assert not [n for n, _, _ in trace.kernels if n.startswith("egom2p.")]
    spans = tracing.spans(trace.host, trace.kernels)
    assert spans == tracing.spans(*tracing.events(prof))
    launched = {e.id: e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU
                and tracing.LAUNCH.match(e.name)}
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("egom2p.", "Optimizer."))]
    assert kernels and all(k.id in launched for k in kernels)
    for name, s in spans.items():
        ranges = [(e.time_range.start, e.time_range.end) for e in _spans_in(prof)
                  if e.name == name]
        exact = sum(k.time_range.elapsed_us() for k in kernels
                    if any(a <= launched[k.id] <= b for a, b in ranges)) / 1e3
        assert s["device_ms"] == pytest.approx(exact, rel=1e-9, abs=1e-9), name
    lo = min(s for n, s, _ in trace.host if n.startswith("egom2p."))
    hi = max(e for n, _, e in trace.host if n.startswith("egom2p."))
    mallocs = [s for n, s, _ in trace.host if n == "cudaMalloc" and lo <= s <= hi]
    allocs = tracing.snapshot()["counters"].get("device.allocs")
    assert allocs is not None and allocs == len(mallocs)
    return spans, allocs


@pytest.mark.gpu
def test_card_serve_batch_spans_are_not_kernels_and_allocs_match(cuda, monkeypatch):
    from egom2p_torch.cli import eval_common
    from egom2p_torch.generate.decode import decode_video_tokens
    from egom2p_torch.generate.sampler import GenerationSampler
    from egom2p_torch.models.egom2p import create_model
    from egom2p_torch.tokenizers.cosmos.network import CausalDiscreteVideoTokenizer
    from egom2p_torch.tokenizers.cosmos.video_api import CausalVideoTokenizer
    from perfbench.tests import small

    small.patch_program(monkeypatch)
    torch.manual_seed(0)
    model = create_model(small.TINY["registry_name"], in_domains=list(MODS4),
                         out_domains=list(MODS4), device=cuda).eval()
    tokenizer = CausalVideoTokenizer(CausalDiscreteVideoTokenizer(
        eval_common.COSMOS_CONFIG).to(cuda))
    sampler = GenerationSampler(model)
    schedule = eval_common.roar_schedule("tok_rgb", "tok_depth", 3, 0.01)
    video = torch.randint(0, 256, (2, 16, 32, 32, 3), dtype=torch.uint8, device=cuda)

    def batch():
        out, _ = eval_common.run_clip(video, sampler, tokenizer, schedule, "tok_rgb",
                                      "tok_depth", seed=3)
        decode_video_tokens(out["tok_depth"]["tensor"], tokenizer, key="tok_depth",
                            grid=small.GRID)

    batch()                      # kernels built, handles made
    torch.cuda.synchronize()
    torch.cuda.empty_cache()     # the profiled batch allocates afresh
    tracing.reset()
    with _cuda_profile() as prof:
        batch()
    assert _names(prof)[:3] == ["egom2p.clip", "egom2p.tokenize", "egom2p.generate"]
    assert _names(prof)[-1] == "egom2p.decode" and tracing.snapshot()["units"] == 1
    spans, allocs = _check_profile(prof)
    assert allocs > 0
    assert all(s["device_ms"] is not None and s["device_ms"] > 0 for s in spans.values())


@pytest.mark.gpu
def test_card_train_step_spans_are_not_kernels_and_allocs_match(cuda, tmp_path):
    from egom2p_torch.cli import run_training

    args = _train_args(tmp_path, "--epoch_size", "2")
    args.device = "cuda"
    run_training.main(args)      # kernels built, handles made
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tracing.reset()
    with _cuda_profile() as prof:
        run_training.main(args)
    assert _names(prof) == TRAIN_UNIT
    spans, allocs = _check_profile(prof)
    assert allocs > 0
    step = spans["egom2p.train.step"]["device_ms"]
    parts = sum(spans[f"egom2p.train.{p}"]["device_ms"]
                for p in ("forward", "backward", "optimizer"))
    assert 0.5 * step < parts <= step * 1.001
