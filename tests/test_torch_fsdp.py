"""FSDP pretraining on the port (core/fsdp.py) against the JAX package's
fsdp=True step and against the port's own data parallelism.

Two ranks over gloo (tests/torch_dist_ranks.py, each its own process) run
the tiny model at float32 on the scaled modalities, sharded, on their rows
of 4-row global batches; the JAX step runs jit_train_step(..., fsdp=True)
on a 2-device data mesh over the whole global batch, from the same
weights (compat/from_jax.py).  Then, in the same rank processes: FSDP
against data parallelism bitwise with clipping off (two fp32 terms sum
alike in either collective), with remat, with the trunk frozen, with a
head that one rank's rows never reach, and a checkpoint written by the
FSDP ranks resumed by data-parallel ranks, by FSDP ranks and by one
process (and the reverse).  Last, the trainer under torchrun with --fsdp
true, resumed without it.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egom2p_torch.compat.from_jax import egom2p_state_dict_from_jax
from egom2p_torch.core import fsdp
from egom2p_torch.core.checkpoint import auto_load_model, load_egom2p_pth, load_pth
from egom2p_torch.core.optim import Optimizer, shared_params_mask
from egom2p_torch.data.modality_info import make_scaled_modality_info
from egom2p_torch.models.egom2p import create_model
from egom2p_torch.train.egom2p_train import make_train_step
from egom2p_tpu.core.mesh import MeshConfig, make_mesh
from egom2p_tpu.core.optim import create_optimizer
from egom2p_tpu.core.schedules import as_optax_schedule
from egom2p_tpu.models.egom2p import create_model as jax_create_model
from egom2p_tpu.train.egom2p_train import fsdp_spec as jax_fsdp_spec
from egom2p_tpu.train.egom2p_train import init_train_state, jit_train_step
from egom2p_tpu.train.egom2p_train import make_train_step as jax_make_train_step
from test_torch_distributed import global_batch, to_jax, transfer_batch

REPO = pathlib.Path(__file__).resolve().parent.parent
RANKS = pathlib.Path(__file__).resolve().parent / "torch_dist_ranks.py"
NAME = "egom2p_tiny_6e_6d_swiglu_nobias"
MODS4 = ("tok_cam", "tok_depth", "tok_gaze", "tok_rgb")
TOKENS = 32
WORLD = 2
LR = 1e-3
# a tensor fsdp_spec shards (384 x 384) and one it does not (32 x 384)
NONE_GRAD = ("decoder_proj_context.weight", "decoder_embeddings.tok_cam.token_emb.weight")
# the rank processes run 14 cases of one or two tiny steps (about 1 s each)
JOIN_TIMEOUT_S = 240
# tests/test_sharding.py:test_fsdp_matches_replicated's tolerances: sharded
# collectives reorder float reductions; Adam amplifies a gradient's rounding
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-4

torch.set_num_threads(2)


@pytest.mark.parametrize("shape, n, want", [
    ((64000, 768), 8, 0), ((768, 2048), 8, 1), ((7,), 8, None), ((130001, 3), 8, None),
    ((1, 5120, 768), 2, 1), ((2304, 384), 3, 0), ((256, 256), 2, 0), ((255, 257), 2, None)])
def test_fsdp_spec_is_jax_rule(shape, n, want):
    """tests/test_sharding.py:179-186's cases and more: the dimension the
    port shards is the one JAX's PartitionSpec names "data"."""
    assert fsdp.fsdp_spec(shape, n) == want
    spec = tuple(jax_fsdp_spec(shape, n))
    assert spec == (() if want is None else tuple("data" if d == want else None
                                                 for d in range(len(shape))))


def run_ranks(job_dir, job, world=WORLD):
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
    return codes, outs, logs


def port_model(state=None, remat=False):
    model = create_model(NAME, MODS4, MODS4, modality_info=make_scaled_modality_info(),
                         compute_dtype="float32", use_act_checkpoint=remat)
    if state is not None:
        model.load_state_dict(state)
    return model


@pytest.fixture(scope="module")
def setup():
    info = make_scaled_modality_info()
    jmodel = jax_create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32")
    rng = np.random.default_rng(1)
    batches = [global_batch(rng, info, (5, 4, 2, 3)) for _ in range(2)]
    params = jmodel.init(jax.random.PRNGKey(0), to_jax(batches[0]), TOKENS, TOKENS)
    state = egom2p_state_dict_from_jax(params, port_model())
    return {"jmodel": jmodel, "params": params, "state": state, "batches": batches,
            "one_head": global_batch(rng, info, (6, 3, 0, 0)), "transfer": transfer_batch(rng, info)}


def jax_fsdp_step(setup, accum):
    """(metrics, parameters after the step as the port's state dict) of
    JAX's fsdp=True step over a 2-device data mesh on the global batch."""
    mesh = make_mesh(MeshConfig(data=WORLD), jax.devices()[:WORLD])
    params = jax.tree_util.tree_map(jnp.array, setup["params"])
    opt = create_optimizer(params, as_optax_schedule(np.array([LR])), weight_decay=0.05,
                           clip_grad=1.0)
    state = init_train_state(params, opt)
    batch = to_jax(setup["batches"][0])
    step = jax_make_train_step(setup["jmodel"], opt, TOKENS, TOKENS, "mod", accum)
    new_state, metrics = jit_train_step(mesh, step, state, batch, fsdp=True)(
        state, batch, jax.random.PRNGKey(3))
    return ({k: float(v) for k, v in metrics.items()},
            egom2p_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new_state.params),
                                       port_model()))


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp")
    refs = {accum: jax_fsdp_step(setup, accum) for accum in (1, 2)}
    b1, b2 = setup["batches"]
    noclip = dict(kind="fsdp", clip=None, batches=[b1])
    cases = {
        **{f"jax{a}": dict(kind="fsdp", fsdp=True, clip=1.0, accum=a, batches=[b1],
                           ref=refs[a][1]) for a in (1, 2)},
        "fsdp": dict(noclip, fsdp=True, keep=True),
        "dp": dict(noclip, same_as="fsdp"),
        "fsdp_remat": dict(noclip, fsdp=True, remat=True, same_as="fsdp"),
        "fsdp_accum2": dict(noclip, fsdp=True, accum=2, keep=True),
        "dp_accum2": dict(noclip, accum=2, same_as="fsdp_accum2"),
        "fsdp_frozen": dict(noclip, fsdp=True, frozen=1, keep=True),
        "dp_frozen": dict(noclip, frozen=1, same_as="fsdp_frozen"),
        # rank 1 holds no cam target, and the gradient of a sharded tensor
        # and of a replicated one (the cam head) is dropped before its
        # reduction: the None that a head no row of a rank reached may leave
        **{f"fsdp_{b}": dict(noclip, fsdp=True, batches=[setup[b]], keep=True,
                             none_grad=NONE_GRAD if b == "one_head" else None)
           for b in ("one_head", "transfer")},
        **{f"dp_{b}": dict(noclip, batches=[setup[b]], same_as=f"fsdp_{b}",
                           none_grad=NONE_GRAD if b == "one_head" else None)
           for b in ("one_head", "transfer")},
        "ck_fsdp": dict(kind="fsdp", fsdp=True, clip=None, batches=[b1, b2],
                        save=str(root / "ck_fsdp"), keep=True),
        "ck_dp_from_fsdp": dict(kind="fsdp", clip=None, batches=[b2], load=str(root / "ck_fsdp"),
                                same_as="ck_fsdp"),
        "ck_dp": dict(kind="fsdp", clip=None, batches=[b1, b2], save=str(root / "ck_dp"),
                      keep=True),
        "ck_fsdp_from_dp": dict(kind="fsdp", fsdp=True, clip=None, batches=[b2],
                                load=str(root / "ck_dp"), same_as="ck_dp"),
    }
    codes, outs, logs = run_ranks(root / "job", {"state": setup["state"], "cases": cases,
                                                 "timeout_s": 60})
    assert codes == [0] * WORLD, logs
    return {"outs": outs, "refs": refs, "root": root}


@pytest.mark.parametrize("accum", [1, 2])
def test_two_fsdp_ranks_equal_jax_fsdp_step(ranks, accum):
    """loss, loss_<mod> and grad_norm within 1e-5 relative of JAX's
    fsdp=True step on the 4-row global batch, every parameter within 2e-4
    after it (at accum 2 each micro-batch is 2 global rows)."""
    ref_metrics, _ = ranks["refs"][accum]
    for out in ranks["outs"]:
        got = out[f"jax{accum}"]
        assert got["synced"]
        for k, v in ref_metrics.items():
            np.testing.assert_allclose(got["metrics"][0][k], v, rtol=LOSS_RTOL, err_msg=k)
        worst = max(got["ref_err"].values())
        assert worst <= PARAM_ATOL, max(got["ref_err"], key=got["ref_err"].get)


@pytest.mark.parametrize("case", ["dp", "fsdp_remat", "dp_accum2", "dp_frozen", "dp_one_head",
                                  "dp_transfer", "ck_dp_from_fsdp", "ck_fsdp_from_dp"])
def test_fsdp_and_data_parallel_steps_are_bitwise_equal(ranks, case):
    """With clipping off, FSDP's parameters after the step equal data
    parallelism's bitwise (and remat's equal no remat's, a resumed run's
    equal the run that went on), on both ranks, the ranks equal."""
    for out in ranks["outs"]:
        assert out[case]["same"] and out[case]["synced"]


def test_fsdp_metrics_equal_data_parallel_metrics(ranks):
    """The losses are the same floats; grad_norm differs only in its last
    bits (norms of the pieces summed over the ranks, not of the whole)."""
    for out in ranks["outs"]:
        a, b = out["fsdp"]["metrics"][0], out["dp"]["metrics"][0]
        assert {k: v for k, v in a.items() if k != "grad_norm"} == \
            {k: v for k, v in b.items() if k != "grad_norm"}
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)


def test_ranks_hold_only_their_pieces_between_steps(setup, ranks):
    """Between steps a rank holds each tensor fsdp_spec shards as its
    piece (element count) and every full parameter's storage is freed."""
    model = port_model(setup["state"])
    expected = sum(p.numel() // (WORLD if fsdp.fsdp_spec(p.shape, WORLD) is not None else 1)
                   for p in model.parameters())
    full = sum(p.numel() for p in model.parameters())
    for out in ranks["outs"]:
        for name in ("fsdp", "ck_fsdp", "fsdp_accum2"):
            assert out[name]["numel"] == expected < 0.6 * full
            assert out[name]["pieces_only"] and all(out[name]["pieces_only"])
        assert out["dp"]["numel"] == full


def test_frozen_trunk_is_held_under_fsdp(setup, tmp_path):
    """One process, one piece (shard_model without a group): the trunk
    frozen for the first step is bitwise unchanged, the rest moved, and
    the pieces are the whole tensors."""
    model = port_model(setup["state"])
    sharded = fsdp.shard_model(model)
    assert all(s.shard.shape == s.full.shape for s in sharded.params)
    from egom2p_torch.core.optim import freeze_until
    opt = freeze_until(1, shared_params_mask(model), Optimizer(model, [LR]), model)
    batch = {m: {k: torch.from_numpy(v) for k, v in d.items()}
             for m, d in setup["batches"][0].items()}
    make_train_step(model, opt, TOKENS, TOKENS)(batch, torch.Generator().manual_seed(5))
    after = fsdp.full_state_dict(model)
    trunk = shared_params_mask(port_model())
    for k, v in setup["state"].items():
        assert torch.equal(after[k], v) == trunk.get(k, False), k


def test_checkpoint_written_by_fsdp_ranks_resumes_in_one_process(setup, ranks):
    """The FSDP ranks' checkpoint (after their first step) is the reference
    .pth layout: load_egom2p_pth reads it, its tensors are full.  One
    process resumes it, sharded in one piece and not sharded: the next
    step's metrics are the ranks' second step's (the global batch on one
    process: the same sums in another order) and its parameters equal the
    ranks' within PARAM_ATOL; the two single-process runs bitwise alike."""
    path = ranks["root"] / "ck_fsdp" / "checkpoint-0.pth"
    ckpt = load_pth(str(path))
    assert ckpt["step"] == 1 and set(ckpt) >= {"model", "optimizer"}
    full = port_model()
    load_egom2p_pth(str(path), full, ckpt)
    assert {k: tuple(v.shape) for k, v in ckpt["model"].items()} == \
        {k: tuple(v.shape) for k, v in full.state_dict().items()}
    b2 = {m: {k: torch.from_numpy(v) for k, v in d.items()}
          for m, d in setup["batches"][1].items()}
    results = []
    for shard in (False, True):
        model = port_model()
        if shard:
            fsdp.shard_model(model)
        opt = Optimizer(model, [LR], clip_grad=None)
        auto_load_model(str(path.parent), model, opt)
        m = make_train_step(model, opt, TOKENS, TOKENS)(b2, torch.Generator().manual_seed(5))
        results.append(({k: v.item() for k, v in m.items()}, fsdp.full_state_dict(model)))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(results[0][1][k], results[1][1][k]) for k in results[0][1])
    ranks_second = ranks["outs"][0]["ck_fsdp"]["metrics"][1]
    for k, v in ranks_second.items():
        np.testing.assert_allclose(results[0][0][k], v, rtol=LOSS_RTOL, err_msg=k)


def test_torchrun_fsdp_trains_and_resumes_without_fsdp(tmp_path):
    """torchrun with 2 CPU processes and --fsdp true: the log's epochs,
    checkpoints of full tensors; a second run without --fsdp resumes from
    them."""
    out = tmp_path / "out"

    def run(epochs, *flags):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "-m", "egom2p_torch.cli.run_training",
               "--synthetic_data", "--scaled_modalities", "--model", NAME,
               "--num_input_tokens", "32", "--num_target_tokens", "32", "--batch_size", "1",
               "--accum_steps", "2", "--epochs", str(epochs), "--epoch_size", "8",
               "--lr_schedule", "constant", "--eval_freq", "1", "--eval_iters", "1",
               "--device", "cpu", "--output_dir", str(out), "--print_freq", "1", *flags]
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=150,
                              env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        return proc.stdout

    first = run(1, "--fsdp", "true")
    assert "fsdp: 79 tensors sharded over 2 process(es)" in first
    assert "2 process(es), global batch 4, 2 steps per epoch" in first
    second = run(2)
    assert f"resumed from {out}/checkpoint-final.pth at step 2, epoch 1" in second
    records = [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]
    assert [r["epoch"] for r in records if "loss" in r] == [0, 1]
    assert all(np.isfinite(r["val_synthetic_val_loss"]) for r in records
               if "val_synthetic_val_loss" in r)
    final = load_pth(str(out / "checkpoint-final.pth"))
    assert final["step"] == 4
    port_model().load_state_dict(final["model"])
    shutil.rmtree(out)
