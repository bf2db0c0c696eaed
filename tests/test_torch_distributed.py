"""Data-parallel pretraining on the port against the JAX step on the global
batch, and the trainer's options that come with it.

Two ranks over gloo (tests/torch_dist_ranks.py, each its own process,
meeting through a file under tmp_path) run the port's step and eval on
their rows of a 4-row global batch; the JAX package's make_train_step /
make_eval_step run once on the whole global batch.  The tiny model at
float32 on the scaled modalities (dense attention and plain CE on both
sides), JAX's random init carried over by compat/from_jax.py.  Every rank
process runs under a join timeout: a rank that waits in a collective its
peer never enters fails the test instead of hanging it.

Then, with no process group: the per-rank shard lists and loader seeds
against the JAX trainer's, TransferMasking against JAX's, the async save,
--profile, wandb, the flags that are not ported, and one run of the
trainer under torchrun with 2 CPU processes, resumed by a second.
"""
import copy
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import run_training_egom2p as jax_trainer
from egom2p_torch.cli import run_training
from egom2p_torch.compat.from_jax import egom2p_state_dict_from_jax
from egom2p_torch.core import checkpoint as port_checkpoint
from egom2p_torch.core import distributed
from egom2p_torch.core.logging import WandbLogger
from egom2p_torch.data.masking import TransferMasking
from egom2p_torch.data.modality_info import MODALITY_INFO
from egom2p_torch.data.modality_info import make_scaled_modality_info
from egom2p_torch.models.egom2p import create_model
import egom2p_tpu.core.mesh as jax_mesh
from egom2p_tpu.masking import TransferMasking as JaxTransferMasking
from egom2p_tpu.models.egom2p import create_model as jax_create_model
from egom2p_tpu.train.egom2p_train import init_train_state
from egom2p_tpu.train.egom2p_train import make_eval_step as jax_make_eval_step
from egom2p_tpu.train.egom2p_train import make_train_step as jax_make_train_step

REPO = pathlib.Path(__file__).resolve().parent.parent
RANKS = pathlib.Path(__file__).resolve().parent / "torch_dist_ranks.py"
NAME = "egom2p_tiny_6e_6d_swiglu_nobias"
MODS4 = ("tok_cam", "tok_depth", "tok_gaze", "tok_rgb")
TOKENS = 32
WORLD = 2
# seconds a rank process may take (a few s to start, well under a second a step)
JOIN_TIMEOUT_S = 45
# the JAX step on the global batch against the two ranks' reduced step, both
# float32 on the dense path: the same sums in another order (measured: the
# losses within 1.4e-7 relative, grad_norm 4.3e-6; the gradients within
# 3.2e-6 of each tensor's max, 2.1e-5 on the TransferMasking batch)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each tensor's max |JAX gradient|

torch.set_num_threads(2)


def global_batch(rng, info, cam_targets):
    """4 rows, per row 3 / 8 / 3 / 8 visible tokens of cam / depth / gaze /
    rgb and `cam_targets[row]` / 8 / 4 / 8 targets among the rest."""
    out = {}
    for i, m in enumerate(MODS4):
        L, V = info[m]["max_tokens"], info[m]["vocab_size"]
        n_in = (3, 8, 3, 8)[i]
        input_mask = np.ones((4, L), bool)
        target_mask = np.ones((4, L), bool)
        for b in range(4):
            n_tgt = cam_targets[b] if m == "tok_cam" else (8, 8, 4, 8)[i]
            order = rng.permutation(L)
            input_mask[b, order[:n_in]] = False
            target_mask[b, order[n_in:n_in + n_tgt]] = False
        out[m] = {"tensor": rng.integers(0, V, (4, L)).astype(np.int32),
                  "input_mask": input_mask, "target_mask": target_mask,
                  "decoder_attention_mask": np.zeros((4, L), np.int32)}
    return out


def transfer_batch(rng, info):
    """4 rows through TransferMasking: rgb and depth in, cam and gaze out."""
    masking = TransferMasking(info, ["tok_rgb", "tok_depth"], ["tok_cam", "tok_gaze"])
    samples = [masking({m: rng.integers(0, info[m]["vocab_size"], info[m]["max_tokens"])
                        .astype(np.int32) for m in MODS4}) for _ in range(4)]
    return {m: {k: np.stack([s[m][k] for s in samples]) for k in samples[0][m]} for m in MODS4}


def to_jax(md):
    return {m: {k: jnp.asarray(v) for k, v in d.items()} for m, d in md.items()}


def grad_capture():
    """An optax transformation whose state after a step is that step's
    gradients: the JAX step's gradients as its optimizer sees them."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads),
                                           grads))


def run_ranks(job_dir, job, world=WORLD):
    """Writes job.pt, runs `world` rank processes on it; returns their exit
    codes and outputs (None where a rank wrote none)."""
    job_dir.mkdir()
    torch.save(job, job_dir / "job.pt")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(RANKS), str(job_dir), str(r), str(world)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    codes, logs = [], []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
            codes.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [torch.load(job_dir / f"rank{r}.pt", weights_only=False)
            if (job_dir / f"rank{r}.pt").exists() else None for r in range(world)]
    shutil.rmtree(job_dir)
    return codes, outs, logs


@pytest.fixture(scope="module")
def setup():
    info = make_scaled_modality_info()
    jmodel = jax_create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32")
    rng = np.random.default_rng(0)
    batch = global_batch(rng, info, cam_targets=(5, 5, 1, 1))
    params = jmodel.init(jax.random.PRNGKey(0), to_jax(batch), TOKENS, TOKENS)
    tmodel = create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32")
    state = egom2p_state_dict_from_jax(params, tmodel)
    return {"info": info, "jmodel": jmodel, "params": params, "tmodel": tmodel,
            "state": state, "batch": batch,
            "eval_batches": [global_batch(rng, info, (2, 6, 3, 1)) for _ in range(2)],
            "transfer": transfer_batch(rng, info)}


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    cases = {"step1": {"kind": "step", "batch": setup["batch"], "accum": 1},
             "step2": {"kind": "step", "batch": setup["batch"], "accum": 2},
             "local": {"kind": "local_loss", "batch": setup["batch"]},
             "eval": {"kind": "eval", "batches": setup["eval_batches"]},
             "transfer": {"kind": "step", "batch": setup["transfer"], "accum": 1},
             **{loss_type: {"kind": "step", "batch": setup["batch"], "accum": 1,
                            "loss_type": loss_type} for loss_type in ("weighted_mod", "token")}}
    codes, outs, logs = run_ranks(tmp_path_factory.mktemp("dist") / "job",
                                  {"state": setup["state"], "cases": cases})
    assert codes == [0] * WORLD, logs
    return outs


def jax_step(setup, batch, accum, loss_type="mod"):
    """(metrics, gradients as the port's state dict) of the JAX step on the
    global batch."""
    opt = grad_capture()
    step = jax.jit(jax_make_train_step(setup["jmodel"], opt, TOKENS, TOKENS, loss_type, accum))
    new_state, metrics = step(init_train_state(setup["params"], opt), to_jax(batch),
                              jax.random.PRNGKey(3))
    return ({k: float(v) for k, v in metrics.items()},
            egom2p_state_dict_from_jax(new_state.opt_state, setup["tmodel"]))


def assert_step_matches(outs, ref_metrics, ref_grads):
    """Every rank's metrics, and rank 0's summed gradients (every rank's
    parameters equal rank 0's after the step), against JAX's."""
    for got in outs:
        assert set(got["metrics"]) == set(ref_metrics)
        for k, v in ref_metrics.items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL, err_msg=k)
    assert outs[0]["grads"]
    for key, g in outs[0]["grads"].items():
        r = ref_grads[key]
        tol = GRAD_TOL * max(r.abs().max().item(), 1e-30)
        assert (g - r).abs().max().item() <= tol, key


@pytest.mark.parametrize("accum", [1, 2])
def test_two_rank_step_equals_jax_step_on_the_global_batch(setup, ranks, accum):
    """loss, loss_<mod> and grad_norm within 1e-5 relative, the reduced
    gradients within 1e-4 of each tensor's max, of the JAX step on the
    4-row global batch; at accum 2 each micro-batch is 2 global rows, one
    from each rank's loader."""
    ref_metrics, ref_grads = jax_step(setup, setup["batch"], accum)
    assert_step_matches([out[f"step{accum}"] for out in ranks], ref_metrics, ref_grads)


@pytest.mark.parametrize("loss_type", ["weighted_mod", "token"])
def test_two_rank_loss_types_use_the_global_counts(setup, ranks, loss_type):
    """weighted_mod rescales each modality's global loss; token weighs the
    modalities by their global target counts: both as JAX's on the global
    batch, whose ranks hold 10 and 2 cam targets."""
    ref_metrics, ref_grads = jax_step(setup, setup["batch"], 1, loss_type)
    assert_step_matches([out[loss_type] for out in ranks], ref_metrics, ref_grads)


@pytest.mark.parametrize("accum", [1, 2])
def test_ranks_hold_bitwise_equal_parameters_after_the_step(ranks, accum):
    """Each rank compared its parameters after the step with rank 0's
    (broadcast), bitwise; the metrics are the same floats on both."""
    a, b = (out[f"step{accum}"] for out in ranks)
    assert a["synced"] and b["synced"]
    assert a["metrics"] == b["metrics"]


def test_mean_of_rank_losses_misses_the_global_loss(setup, ranks):
    """Negative control: the ranks hold 10 and 2 cam targets, so the mean
    of the per-rank losses (what averaging per-rank means would train) is
    another number than JAX's global loss, by far more than LOSS_RTOL."""
    ref_metrics, _ = jax_step(setup, setup["batch"], 1)
    mean_of_ranks = np.mean([out["local"] for out in ranks])
    assert abs(mean_of_ranks - ref_metrics["loss"]) > 10 * LOSS_RTOL * abs(ref_metrics["loss"])
    np.testing.assert_allclose(ranks[0]["step1"]["metrics"]["loss"], ref_metrics["loss"],
                               rtol=LOSS_RTOL)


def test_two_rank_eval_equals_jax_eval_on_the_global_rows(setup, ranks):
    """run_eval on 2 ranks (each on its rows of every global batch) gives
    the mean of JAX's eval step over the global batches."""
    step = jax.jit(jax_make_eval_step(setup["jmodel"], TOKENS, TOKENS, "mod"))
    per_batch = [step(setup["params"], to_jax(b)) for b in setup["eval_batches"]]
    for out in ranks:
        got = out["eval"]
        assert set(got) == {f"val_{k}" for k in per_batch[0]}
        for k in per_batch[0]:
            ref = np.mean([float(m[k]) for m in per_batch])
            np.testing.assert_allclose(got[f"val_{k}"], ref, rtol=LOSS_RTOL, err_msg=k)
    assert ranks[0]["eval"] == ranks[1]["eval"]


def test_transfer_masking_step_on_two_ranks(setup, ranks):
    """TransferMasking (rgb, depth in; cam, gaze out): the input-only
    modalities' heads get no target, the ranks' step still meets in every
    collective, matches JAX and leaves bitwise-equal parameters."""
    ref_metrics, ref_grads = jax_step(setup, setup["transfer"], 1)
    assert ref_metrics["loss_tok_rgb"] == ref_metrics["loss_tok_depth"] == 0.0
    assert_step_matches([out["transfer"] for out in ranks], ref_metrics, ref_grads)
    assert all(out["transfer"]["synced"] for out in ranks)


def test_a_rank_left_waiting_fails_within_the_timeout(tmp_path):
    """Rank 0 enters a collective that rank 1 never does: rank 0 fails (the
    group's timeout, or its peer gone), it does not hang."""
    codes, outs, logs = run_ranks(tmp_path / "job", {"state": None, "timeout_s": 5,
                                                     "cases": {"hang": {"kind": "hang"}}})
    assert codes[1] == 0 and codes[0] != 0, logs
    assert outs[0] is None


# ------------------------------------------------------ no process group
@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("split", [True, False])
def test_expand_modality_shards_per_rank_matches_jax(monkeypatch, world, split):
    path = "/data/[rgb,depth,cam]/train/shard-{000..006}.tar"
    info = {m: MODALITY_INFO[m] for m in ("tok_rgb", "tok_depth", "tok_cam")}
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    seen = []
    for r in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        got = run_training.expand_modality_shards(path, info, "train", split=split)
        assert got == jax_trainer.expand_modality_shards(path, info, "train", split=split)
        seen.append(got["tok_rgb"])
    if split:  # a partition of the 7 shards
        assert sorted(s for part in seen for s in part) == sorted(
            run_training.expand_modality_shards(path, info, "train", split=False)["tok_rgb"])
    else:
        assert all(len(s) == 7 for s in seen)


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_loader_matches_jax_loader_at_its_seed(monkeypatch, rank):
    """Rank r's synthetic loader gives the JAX trainer's process-r loader's
    batches (seed + 7919 r), exactly."""
    argv = ["--synthetic_data", "--scaled_modalities", "--batch_size", "2", "--accum_steps",
            "2", "--num_input_tokens", "32", "--num_target_tokens", "32", "--seed", "4"]
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    # process r of 2, one device each
    monkeypatch.setattr(jax_mesh, "local_num_data_shards", lambda mesh: 1)
    monkeypatch.setattr(distributed, "rank", lambda: rank)
    port, _ = run_training.setup_data(run_training.get_args(argv))
    ref, _ = jax_trainer.setup_data(jax_trainer.get_args(argv), None)
    port_it, ref_it = iter(port), iter(ref)
    try:
        for _ in range(2):
            a, b = next(port_it), next(ref_it)
            assert a.keys() == b.keys()
            for m in a:
                for k in a[m]:
                    assert a[m][k].shape[0] == 4
                    np.testing.assert_array_equal(a[m][k], b[m][k], err_msg=f"{m} {k}")
    finally:
        port_it.close()
        ref_it.close()
    assert port.seed == ref.seed == 4 + 7919 * rank
    # a forked worker reseeds the masking from its loader's seed: there the
    # ranks' batches differ (at 0 workers the masking's seed is every rank's)
    firsts = []
    for r in (rank, 1 - rank):
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        it = iter(run_training.setup_data(run_training.get_args(argv + ["--num_workers",
                                                                         "1"]))[0])
        try:
            firsts.append(next(it)["tok_rgb"])
        finally:
            it.close()
    assert not all(np.array_equal(firsts[0][k], firsts[1][k]) for k in firsts[0])


def test_stochastic_depth_masks_are_the_global_batch_rows():
    """With rows = (first, total) a rank draws the masks of the whole
    global micro-batch and keeps its rows: the ranks' masks together are
    one process's masks for the global batch, and the generators stay in
    step."""
    model = create_model(NAME, MODS4, MODS4, modality_info=make_scaled_modality_info(),
                         drop_path_rate_encoder=0.5)
    model.train()
    blk = model.encoder[-1]
    full = model._keep_masks(blk, 2, 6, torch.Generator().manual_seed(3), "cpu")
    parts = [model._keep_masks(blk, 2, 2, torch.Generator().manual_seed(3), "cpu", (2 * r, 6))
             for r in range(3)]
    assert torch.equal(torch.cat(parts, dim=1), full) and 0 < full.sum() < full.numel()


def test_transfer_masking_matches_jax():
    info = make_scaled_modality_info()
    rng = np.random.default_rng(2)
    port = TransferMasking(info, ["tok_rgb", "tok_cam"], ["tok_depth", "tok_gaze"])
    ref = JaxTransferMasking(info, None, ["tok_rgb", "tok_cam"], ["tok_depth", "tok_gaze"])
    for _ in range(3):
        sample = {m: rng.integers(0, info[m]["vocab_size"], info[m]["max_tokens"])
                  .astype(np.int32) for m in MODS4}
        a, b = port(sample), ref(sample)
        assert a.keys() == b.keys()
        for m in a:
            for k in b[m]:
                np.testing.assert_array_equal(a[m][k], b[m][k], err_msg=f"{m} {k}")
                assert a[m][k].dtype == b[m][k].dtype
    assert a["tok_depth"]["decoder_attention_mask"][0] == info["tok_depth"]["max_tokens"]
    assert not a["tok_rgb"]["input_mask"].any() and a["tok_rgb"]["target_mask"].all()
    # a modality in neither set raises, as JAX's does; text is not ported
    partial = TransferMasking(info, ["tok_rgb"], ["tok_depth"])
    with pytest.raises(ValueError, match="not in input or target set"):
        partial(sample)
    with pytest.raises(ValueError, match="not in input or target set"):
        JaxTransferMasking(info, None, ["tok_rgb"], ["tok_depth"])(sample)
    text = copy.deepcopy(info)
    text["tok_cam"]["type"] = "seq"
    with pytest.raises(NotImplementedError, match="text modalities are not ported"):
        TransferMasking(text, ["tok_rgb", "tok_cam"], ["tok_depth", "tok_gaze"])(sample)


def test_trainer_takes_transfer_masking_on_synthetic_data():
    args = run_training.get_args(["--synthetic_data", "--scaled_modalities", "--batch_size",
                                  "2", "--input_domains", "tok_rgb-tok_depth",
                                  "--target_domains", "tok_cam-tok_gaze"])
    loader, _ = run_training.setup_data(args)
    it = iter(loader)
    try:
        b = next(it)
    finally:
        it.close()
    assert b["tok_rgb"]["target_mask"].all() and not b["tok_rgb"]["input_mask"].any()
    assert b["tok_cam"]["input_mask"].all() and not b["tok_cam"]["target_mask"].any()
    args.target_domains = None
    with pytest.raises(ValueError, match="go together"):
        run_training.setup_data(args)


def test_async_save_writes_the_state_of_its_call(tmp_path):
    """An async save's file is byte-equal to a blocking save's; a parameter
    changed right after save_checkpoint(blocking=False) returns is absent
    from the file."""
    model = create_model(NAME, MODS4, MODS4, modality_info=make_scaled_modality_info())
    model.init_random_(torch.Generator().manual_seed(0))
    args = {"model": NAME}
    sync = port_checkpoint.save_checkpoint(tmp_path / "a", "final", model, step=3, args=args)
    path = port_checkpoint.save_checkpoint(tmp_path / "b", "final", model, step=3, args=args,
                                           blocking=False)
    before = model.mask_token.detach().clone()
    with torch.no_grad():
        model.mask_token.add_(1.0)
    port_checkpoint.wait_for_saves()
    assert pathlib.Path(sync).read_bytes() == pathlib.Path(path).read_bytes()
    loaded = port_checkpoint.load_pth(path)
    assert torch.equal(loaded["model"]["mask_token"], before)
    assert not torch.equal(loaded["model"]["mask_token"], model.mask_token.detach())
    # the shared modality embeddings stay one storage in the file
    shared = "decoder_embeddings.tok_rgb.mod_emb", "encoder_embeddings.tok_rgb.mod_emb"
    sd = loaded["model"]
    assert sd[shared[0]].untyped_storage().data_ptr() == sd[shared[1]].untyped_storage().data_ptr()
    shutil.rmtree(tmp_path / "a")
    shutil.rmtree(tmp_path / "b")


def test_profile_writes_a_trace_on_the_cpu(tmp_path):
    args = run_training.get_args([
        "--synthetic_data", "--scaled_modalities", "--model", NAME, "--num_input_tokens",
        "32", "--num_target_tokens", "32", "--batch_size", "2", "--epochs", "1",
        "--epoch_size", "4", "--eval_freq", "0", "--lr_schedule", "constant", "--device",
        "cpu", "--output_dir", str(tmp_path), "--profile"])
    run_training.main(args)
    trace = tmp_path / "profile" / "trace-rank0.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert sorted(os.listdir(tmp_path / "profile")) == ["trace-rank0.json"]
    (tmp_path / "checkpoint-final.pth").unlink()  # 0.3 GB


def test_wandb_logger_is_a_no_op_without_wandb(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb fails
    logger = WandbLogger(run_training.get_args(["--log_wandb"]))
    logger.log({"loss": 1.0}, step=3)
    logger.finish()
    assert "wandb disabled" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--fsdp", "true"], ["--tensor_parallel", "2"],
                                  ["--s3_save_dir", "s3://bucket/run"]])
def test_flags_not_ported_raise(tmp_path, flag):
    args = run_training.get_args(["--synthetic_data", "--scaled_modalities", "--device", "cpu",
                                  "--output_dir", str(tmp_path), *flag])
    with pytest.raises(NotImplementedError):
        run_training.main(args)
    assert not list(tmp_path.iterdir())


def test_world_size_without_rank_raises(monkeypatch, tmp_path):
    """WORLD_SIZE=2 with no RANK: the trainer raises, it does not train alone."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    args = run_training.get_args(["--synthetic_data", "--scaled_modalities", "--device", "cpu",
                                  "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="RANK"):
        run_training.main(args)
    assert not distributed.initialized()


def test_torchrun_trains_two_cpu_processes_and_resumes(tmp_path):
    """torchrun with 2 CPU processes: one log.txt line per epoch (rank 0
    writes), an async periodic save and a blocking final one, a resume by
    a second run, and a checkpoint-final.pth that loads."""
    out = tmp_path / "out"

    def run(epochs):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "-m", "egom2p_torch.cli.run_training",
               "--synthetic_data", "--scaled_modalities", "--model", NAME,
               "--num_input_tokens", "32", "--num_target_tokens", "32", "--batch_size", "1",
               "--accum_steps", "2", "--epochs", str(epochs), "--epoch_size", "8",
               "--lr_schedule", "constant", "--eval_freq", "0", "--device", "cpu",
               "--output_dir", str(out), "--print_freq", "1"]
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120,
                              env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        return proc.stdout

    first = run(1)
    assert "2 process(es), global batch 4, 2 steps per epoch" in first
    second = run(3)
    assert f"resumed from {out}/checkpoint-final.pth at step 2, epoch 1" in second
    assert f"saved (async) {out}/checkpoint-1.pth" in second
    assert f"saved {out}/checkpoint-final.pth" in second
    records = [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in records)
    final = port_checkpoint.load_pth(str(out / "checkpoint-final.pth"))
    assert final["step"] == 6 and not any(k.startswith("module.") for k in final["model"])
    model = create_model(NAME, MODS4, MODS4, modality_info=make_scaled_modality_info())
    model.load_state_dict(final["model"])
    assert port_checkpoint.load_pth(str(out / "checkpoint-1.pth"))["step"] == 4
    shutil.rmtree(out)  # 0.6 GB of checkpoints
