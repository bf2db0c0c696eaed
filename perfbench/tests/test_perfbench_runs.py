"""Whole runs of the serving and training drivers at small sizes on the CPU
(the harness's look for a card skipped), sound and with the timed path
broken underneath: each fault a cell can have must turn `correct` false.

- serving: a served token altered where it is produced;
- training: a step that returns its state unchanged; half of the batch left
  out, the mean taken over the rest; a masker that feeds a quarter fewer
  tokens;
- across ranks (two gloo ranks): the exchange of gradients left out.
"""
import numpy as np
import pytest
import torch

from perfbench import core
from perfbench import run as runner
from perfbench.drivers import serve, train
from perfbench.tests import small

torch.set_num_threads(4)
CPU = torch.device("cpu")


@pytest.fixture
def small_program(monkeypatch):
    small.patch_program(monkeypatch)
    return monkeypatch


def _serve_ctx(seed, trace=False):
    tr = core.load_json("traffic", "rgb2depth.b8.json")
    tr.update(batch=2, clip=[16, 32, 32, 3], pool=4)
    return runner.context("serve.rgb2depth.b8", seed, 0.5, trace, CPU,
                          config=small.small_config(), traffic=tr)


def _train_ctx(seed, trace=False):
    tr = core.load_json("traffic", "mod4.b8.json")
    tr.update(batch=2, num_input_tokens=32, num_target_tokens=32, shards=2,
              samples_per_shard=8, trace_after=1, traced_steps=1)
    tr["dataset"].update(num_input_tokens=32, num_target_tokens=32)
    return runner.context("train.base.b8", seed, 0.5, trace, CPU,
                          config=small.small_config(), traffic=tr)


def _line(ctx, res):
    names = runner.metrics_for(runner.benchmark(), ctx.workload, ctx.trace)
    return runner.result_line(ctx, res, names, "cpu")


@pytest.mark.parametrize("decode", [True, False])
def test_sound_serving_run_is_correct(small_program, decode):
    ctx = _serve_ctx(2 ** 31 + 5)
    ctx.traffic["decode"] = decode
    line = _line(ctx, serve.run(ctx))
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"clips_per_s", "peak_mem_gib", "setup_s"}
    assert line["attempted"] >= 2 and list(line)[-1] == "checks"
    assert ("video_off" in line["checks"]) == decode


def test_serving_traffic_at_another_top_p_than_the_programs_is_refused(small_program):
    ctx = _serve_ctx(3)
    ctx.traffic["top_p"] = 0.9
    with pytest.raises(ValueError, match="top_p"):
        serve.run(ctx)


def test_served_token_altered_where_produced_is_not_correct(small_program):
    from egom2p_torch.cli import eval_common
    real = eval_common.run_clip

    def altered(*args, **kwargs):
        out, secs = real(*args, **kwargs)
        t = out["tok_depth"]["tensor"]
        t[0, 0] = (t[0, 0] + 12345) % 64000
        return out, secs

    small_program.setattr(eval_common, "run_clip", altered)
    ctx = _serve_ctx(9)
    line = _line(ctx, serve.run(ctx))
    assert not line["correct"]
    assert line["checks"]["gap_max"]["value"] > line["checks"]["gap_max"]["limit"]


def test_sound_training_run_is_correct(small_program):
    ctx = _train_ctx(2 ** 31 + 7)
    line = _line(ctx, train.run(ctx))
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_tokens_per_s", "train_step_ms_p90", "peak_mem_gib",
                                    "setup_s"}


def test_training_step_that_leaves_its_state_unchanged_is_not_correct(small_program):
    from egom2p_torch.core import optim
    small_program.setattr(optim.Optimizer, "step",
                          lambda self: torch.zeros(()))
    ctx = _train_ctx(21)
    line = _line(ctx, train.run(ctx))
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] > line["checks"]["change_gap"]["limit"]


def test_training_on_half_the_batch_is_not_correct(small_program):
    from egom2p_torch.models.egom2p import EgoM2P
    real = EgoM2P.forward

    def half(self, mod_dict, *args, **kwargs):
        rows = next(iter(next(iter(mod_dict.values())).values())).shape[0]
        kept = {m: {k: v[: max(rows // 2, 1)] for k, v in d.items()} for m, d in mod_dict.items()}
        return real(self, kept, *args, **kwargs)

    small_program.setattr(EgoM2P, "forward", half)
    ctx = _train_ctx(33)
    line = _line(ctx, train.run(ctx))
    assert not line["correct"]
    worst = max(c["value"] / c["limit"] for n, c in line["checks"].items() if c["limit"] > 0)
    assert worst > 1


def test_masker_that_feeds_a_quarter_fewer_tokens_is_not_correct(small_program):
    from egom2p_torch.data.masking import UnifiedMasking
    real = UnifiedMasking._budget
    small_program.setattr(UnifiedMasking, "_budget",
                          lambda self, *a, **k: [b * 3 // 4 for b in real(self, *a, **k)])
    ctx = _train_ctx(45)
    line = _line(ctx, train.run(ctx))
    assert not line["correct"]
    assert line["checks"]["masked_rows_bad"]["value"] > 0


def test_traced_runs_report_the_per_layer_metrics(small_program):
    ctx = _serve_ctx(4, trace=True)
    line = _line(ctx, serve.run(ctx))
    assert {"tokenize_ms.serve", "generate_ms.serve", "decode_ms.serve",
            "mfu.serve"} <= set(line["metrics"])
    assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    ctx = _train_ctx(6, trace=True)
    line = _line(ctx, train.run(ctx))
    assert {"data_wait_ms.train", "step_fn_ms.train", "mfu.train"} <= set(line["metrics"])
    assert np.isfinite(line["metrics"]["mfu.train"]["value"])


def _dp_ctx(seed):
    tr = core.load_json("traffic", "mod4.b8.dp4.json")
    tr.update(batch=2, world=2, num_input_tokens=32, num_target_tokens=32, shards=4,
              samples_per_shard=8, trace_after=1, traced_steps=1)
    tr["dataset"].update(num_input_tokens=32, num_target_tokens=32)
    return runner.context("train.base.dp4", seed, 1.0, False, CPU, config=small.small_config(),
                          traffic=tr, rank_module="perfbench.tests.dp_rank")


@pytest.mark.parametrize("fault,late", [("", "1"), ("no_all_reduce", "")])
def test_data_parallel_run_on_two_cpu_ranks(monkeypatch, fault, late):
    """Two gloo ranks against the reference on the global batch, rank 0
    closing the window for both; with the gradients' exchange left out,
    `correct` is false."""
    from perfbench.drivers import train_dp
    small.patch_program(monkeypatch)
    monkeypatch.setenv("FAULT", fault)
    monkeypatch.setenv("LATE_WINDOW", late)
    ctx = _dp_ctx(2 ** 31 + 41)
    line = _line(ctx, train_dp.run(ctx))
    assert line["correct"] == (fault == ""), line["checks"]
    assert line["device"]["count"] == 2
