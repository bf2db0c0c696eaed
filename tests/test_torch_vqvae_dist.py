"""The cam / gaze VQ-VAE trainer across processes on the port, against the
JAX package on the global batch, on the CPU at a small width (dim 64, 2 + 2
blocks, 2 heads, latent 8, 16 codes), fp32.

Two ranks over gloo (tests/torch_dist_ranks.py) each hold half of a global
batch:
* ops/vq.py:vq_forward with the statistics summed and the replacement
  pool gathered over the ranks, against egom2p_tpu.ops.vq.vq_forward on
  the global latents, cosine and euclidean, batch_random and
  linde_buzo_gray (the draws JAX takes from its key): the codebook state,
  the indices and the commitment loss;
* train steps (train/vqvae_train.py) against make_vqvae_train_step
  with run_training_vqvae.py's optax chain on the global batch, cam (mse)
  and gaze (mse_mask: the mask count summed over the ranks), both
  policies, codes expiring from the first step: the metrics, the weights
  and the codebook within test_torch_vqvae_train.py's bounds, and the
  ranks' weights and codebook bitwise equal.
Then `python -m egom2p_torch.cli.run_training_vqvae` under torchrun with 2
CPU processes against JAX's step on batch_size x 2 rows from the same
initial weights, in the JAX trainer's batch order: before this the two
processes trained two codebooks of their own on the same rows.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import egom2p_tpu.tokenizers.seq_vqvae as jseq
from egom2p_torch.cli import run_training_vqvae
from egom2p_torch.compat.from_jax import seq_vqvae_state_dict_from_jax
from egom2p_torch.core.checkpoint import load_pth, save_seq_vqvae_pth
from egom2p_torch.core.schedules import cosine_scheduler
from egom2p_tpu.compat import torch_convert
from egom2p_tpu.core.schedules import as_optax_schedule
from egom2p_tpu.ops import vq as jvq
from egom2p_tpu.train.vqvae_train import init_train_state, make_vqvae_train_step as jax_step
from test_torch_fsdp import run_ranks
from test_torch_tokenize_tools import SMALL_ARGS, SMALL_SEQ, cam_paths
from test_torch_vqvae_train import (BETAS, LOSS, THRESHOLD, VQ_ATOL, WD, _adam_noisy, _close,
                                    _jax_adam_nu, _vq_case, make_batch, pair)

REPO = pathlib.Path(__file__).resolve().parent.parent
K, D = SMALL_SEQ["codebook_size"], SMALL_SEQ["latent_dim"]
WORLD, ROWS, LR = 2, 8, 1e-3

torch.set_num_threads(2)


def jax_vq_case(cosine, policy):
    embed, cluster, x = _vq_case(cosine, 1)
    kw = dict(codebook_size=K, dim=D, decay=0.9, threshold_ema_dead_code=2.0,
              commitment_weight=0.7, use_cosine_sim=cosine, code_replacement_policy=policy)
    avg = None if cosine else embed * 2.0
    state = jvq.VQState(embed=jnp.asarray(embed), cluster_size=jnp.asarray(cluster),
                        initted=jnp.ones((), bool), embed_avg=None if avg is None else
                        jnp.asarray(avg))
    key = jax.random.PRNGKey(7)
    _, commit, ind, new = jvq.vq_forward(jvq.VQConfig(**kw), state, jnp.asarray(x),
                                         training=True, rng=key)
    draws = ({"replace_idx": torch.from_numpy(np.array(
        jax.random.randint(key, (K,), 0, x.size // D)))} if policy == "batch_random" else
        {"lbg_noise": torch.from_numpy(np.array(jax.random.normal(key, (K, D))))})
    case = {"kind": "vq", "cfg": kw, "x": x, "draws": draws,
            "state": {"embed": embed, "cluster_size": cluster, "initted": np.ones(1, np.float32),
                      "embed_avg": avg}}
    return case, (float(commit), np.asarray(ind), new)


def jax_steps(domain, policy, steps):
    """The JAX trainer's `steps` steps on global batches of ROWS rows, and
    the port's rank case for the same weights, batches and draws."""
    jt, tt = pair(domain, seed=1, threshold_ema_dead_code=THRESHOLD,
                  code_replacement_policy=policy)
    sched = cosine_scheduler(LR, 0.0, 1, steps, warmup_epochs=0)
    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(as_optax_schedule(sched), b1=BETAS[0], b2=BETAS[1],
                                   weight_decay=WD))
    step = jax.jit(jax_step(jt.module, jt.vq_cfg, jopt, loss_fn=LOSS[domain]))
    state = init_train_state(jt.params, jopt, jt.vq_state)
    rng, key = np.random.default_rng(2), jax.random.PRNGKey(5)
    batches, draws, metrics = [], [], []
    for _ in range(steps):
        batch = make_batch(domain, rng, ROWS)
        key, k = jax.random.split(key)
        state, m = step(state, jnp.asarray(batch), k)
        batches.append(batch)
        metrics.append({n: float(v) for n, v in m.items()})
        draws.append({"replace_idx": torch.from_numpy(np.array(
            jax.random.randint(k, (K,), 0, ROWS * 30)))} if policy == "batch_random" else
            {"lbg_noise": torch.from_numpy(np.array(jax.random.normal(k, (K, D))))})
    assert (np.asarray(state.vq_state.cluster_size) < THRESHOLD).any()
    case = {"kind": "vqvae", "domain": domain, "config": {**SMALL_SEQ,
            "threshold_ema_dead_code": THRESHOLD, "code_replacement_policy": policy},
            "state": tt.net.state_dict(), "sched": sched, "wd": WD, "betas": BETAS,
            "loss_fn": LOSS[domain], "batches": batches, "draws": draws}
    return case, metrics, seq_vqvae_state_dict_from_jax(state.params, state.vq_state, tt), \
        seq_vqvae_state_dict_from_jax(_jax_adam_nu(state.opt_state), state.vq_state, tt)


VQ_CASES = [(c, p) for c in (True, False) for p in ("batch_random", "linde_buzo_gray")]
# linde_buzo_gray one step: its replacements are used codes plus 1e-10
# noise, and a latent between such a pair takes either code in the next
# lookup, in either package (the replacement itself is held above)
STEP_CASES = [("cam", "batch_random", 2), ("cam", "linde_buzo_gray", 1),
              ("gaze", "batch_random", 2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases, refs = {}, {}
    for cosine, policy in VQ_CASES:
        name = f"vq_{cosine}_{policy}"
        cases[name], refs[name] = jax_vq_case(cosine, policy)
    for domain, policy, steps in STEP_CASES:
        name = f"step_{domain}_{policy}"
        cases[name], *refs[name] = jax_steps(domain, policy, steps)
    codes, outs, logs = run_ranks(tmp_path_factory.mktemp("vqvae") / "job",
                                  {"state": None, "cases": cases, "timeout_s": 60})
    assert codes == [0] * WORLD, logs
    return outs, refs


@pytest.mark.parametrize("cosine, policy", VQ_CASES)
def test_two_rank_vq_forward_equals_jax_on_the_global_latents(ranks, cosine, policy):
    outs, refs = ranks
    commit, ind, new = refs[f"vq_{cosine}_{policy}"]
    got = [o[f"vq_{cosine}_{policy}"] for o in outs]
    np.testing.assert_array_equal(np.concatenate([g["ind"] for g in got]), ind)
    np.testing.assert_allclose(sum(g["commit"] for g in got), commit, rtol=1e-6)
    expired = np.asarray(new.cluster_size) < 2.0
    assert expired.any() and not expired.all()
    for name in ("embed", "cluster_size") + (() if cosine else ("embed_avg",)):
        want = np.asarray(getattr(new, name))
        for g in got:  # the same codebook on both ranks
            np.testing.assert_allclose(g["state"][name], want, atol=VQ_ATOL, rtol=0,
                                       err_msg=name)
        np.testing.assert_array_equal(got[0]["state"][name], got[1]["state"][name])


@pytest.mark.parametrize("domain, policy, steps", STEP_CASES)
def test_two_rank_vqvae_steps_equal_jax_on_the_global_batch(ranks, domain, policy, steps):
    outs, refs = ranks
    name = f"step_{domain}_{policy}"
    metrics, ref, jax_nu = refs[name]
    for out in outs:
        got = out[name]
        assert got["synced"]  # weights and codebook bitwise equal on the ranks
        for i, want in enumerate(metrics):
            for k, v in want.items():
                _close(got["metrics"][i][k], v, f"step {i} {k}")
    lr_sum = float(np.sum(cosine_scheduler(LR, 0.0, 1, steps, warmup_epochs=0)))
    nu = outs[0][name]["nu"]
    for key, t in outs[0][name]["state"].items():
        # within Adam's noise where both packages' second moments say so
        noisy = _adam_noisy(nu[key]) & _adam_noisy(jax_nu[key]) if key in nu else None
        _close(t.numpy(), ref[key].numpy(), key, noisy, lr_sum if key in nu else 0.0)


def test_vqvae_cli_under_torchrun_takes_jax_steps_on_the_global_batch(tmp_path):
    """2 CPU processes at --batch_size 4 on 8 samples: one step on the
    global batch of 8 rows in the JAX trainer's order (np.random.
    default_rng(seed).permutation), at LR blr x 8 / 256, equal to JAX's
    step from the same initial weights; rank 0 alone wrote the files.  (A
    second Adam step divides by the first's moments and turns the
    packages' rounding into a share of a step that one process's run at 8
    rows shows as well: test_two_rank_vqvae_steps_equal_jax_on_the_global_
    batch holds two steps at the bounds' own LR.)"""
    data = cam_paths(np.random.default_rng(0), 8)
    np.save(tmp_path / "cam.npy", data)
    out = tmp_path / "out"
    argv = ["--domain", "cam", "--data_path", str(tmp_path / "cam.npy"), "--output_dir",
            str(out), "--device", "cpu", *SMALL_ARGS, "--batch_size", "4", "--epochs", "1",
            "--warmup_epochs", "0", "--blr", "0.05", "--coef_ema_dead_code", "0",
            "--eval_freq", "0", "--print_freq", "1", "--seed", "3"]
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "2", "-m", "egom2p_torch.cli.run_training_vqvae",
                           *argv], cwd=REPO, capture_output=True, text=True, timeout=150,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "2 process(es), global batch 8, 1 steps per epoch" in proc.stdout
    assert proc.stdout.count("saved ") == 1  # rank 0 prints and saves
    assert sorted(os.listdir(out)) == ["checkpoint-final.pth", "log.txt"]
    assert len((out / "log.txt").read_text().splitlines()) == 1
    got = load_pth(str(out / "checkpoint-final.pth"))
    assert got["step"] == 1

    # JAX's trainer from the port's initial weights (the CLI's seeded init)
    args = run_training_vqvae.get_args(argv)
    tok = run_training_vqvae.build_tokenizer(args, torch.device("cpu"),
                                             torch.Generator().manual_seed(args.seed))
    save_seq_vqvae_pth(tok, str(tmp_path / "init.pth"))
    orig = jseq.seq_vqvae_from_config
    try:
        jseq.seq_vqvae_from_config = lambda d, rng, **kw: orig(
            d, rng, **{**kw, **SMALL_SEQ, "threshold_ema_dead_code": 0.0})
        jt = torch_convert.load_seq_vqvae_pth(str(tmp_path / "init.pth"), "cam")
    finally:
        jseq.seq_vqvae_from_config = orig
    lr = args.blr * 8 / 256
    sched = cosine_scheduler(lr, args.min_lr, 1, 1, warmup_epochs=0)
    jopt = optax.chain(optax.clip_by_global_norm(args.clip_grad),
                       optax.adamw(as_optax_schedule(sched), b1=args.opt_betas[0],
                                   b2=args.opt_betas[1], weight_decay=args.weight_decay))
    step = jax.jit(jax_step(jt.module, jt.vq_cfg, jopt, loss_fn="mse"))
    state = init_train_state(jt.params, jopt, jt.vq_state)
    order = np.random.default_rng(args.seed).permutation(8)
    x = run_training_vqvae.load_seq_data(args, str(tmp_path / "cam.npy"))
    state, _ = step(state, jnp.asarray(x[order]), jax.random.PRNGKey(0))
    ref = seq_vqvae_state_dict_from_jax(state.params, state.vq_state, tok)
    jax_nu = seq_vqvae_state_dict_from_jax(_jax_adam_nu(state.opt_state), state.vq_state, tok)
    # the Adam state's order is the parameters' (every one decayed: one group)
    moments = got["optimizer"]["adamw"]["state"]
    nu = {n: moments[i]["exp_avg_sq"] for i, (n, _) in enumerate(tok.net.named_parameters())}
    for key, t in got["model"].items():
        noisy = _adam_noisy(nu[key]) & _adam_noisy(jax_nu[key]) if key in nu else None
        _close(t.numpy(), ref[key].numpy(), key, noisy,
               float(np.sum(sched)) if key in nu else 0.0)
    records = [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]
    assert np.isfinite(records[0]["loss"])
