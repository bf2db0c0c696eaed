"""The gradient-quantizer VQ-VAEs (taming, memcodes) on the port against the
JAX package, on the CPU at small widths, the JAX weights carried over by
compat/from_jax.py:grad_vqvae_state_dict_from_jax:

* the state dict: the JAX tree key for key (`core.*`, `quantizer.*`), no
  EMA codebook buffer;
* three train steps of train/vqvae_train.py:make_grad_vqvae_train_step
  against JAX's make_grad_vqvae_train_step with run_training_vqvae.py's
  optax chain, for both quantizers on the cam core (dim 64, 2 + 2 blocks)
  and on a small video core (4 x 32^2 clips, tubelet 2, patch 8, dim 48,
  forced dense as JAX's CPU einsum), Memcodes with JAX's gumbel draws
  passed in: the metrics and every parameter under the criterion of
  tests/test_torch_vqvae_train.py (STEP_RTOL of a tensor's max plus
  ADAM_SHARE of the steps' LR; elements within Adam's noise bounded in
  steps).  An element counts as within Adam's noise from the first step
  at which both packages' second moments put it there: an update Adam
  took on a gradient within rounding of zero (g / (|g| + eps) with |g|
  near eps after clipping a norm of 60-130) stays in the parameter after
  the element's gradient grows (0.025 steps seen on an encoder MLP weight
  whose first-step gradient was at the fp32 noise of its tensor; the
  gradients themselves agree within 1.1e-6 of each tensor's max);
* a feature core's decode_tokens: JAX's hands FeatureViT a flat (B, N, D)
  latent and raises; the port restores the (h, w) grid and decodes what
  autoencode_train decodes;
* the CLI's train, resume (the checkpoint's weights and optimizer back
  bitwise), --eval_only and --tokenize for both quantizers on cam, rgb
  video and CLIP-B16 (its registry entry cut to a small width).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import egom2p_torch.models.teachers as tteach
import egom2p_torch.models.transformer as port_transformer
import egom2p_torch.ops.flash_attention as port_fa
from egom2p_torch.cli import run_training_vqvae as tcli
from egom2p_torch.compat.from_jax import grad_vqvae_state_dict_from_jax
from egom2p_torch.core.checkpoint import load_pth, load_vqvae_pth
from egom2p_torch.core.optim import Optimizer
from egom2p_torch.core.schedules import cosine_scheduler
from egom2p_torch.data.cam_gaze import smooth_cam_trajectories
from egom2p_torch.tokenizers import feature_vqvae as tfv
from egom2p_torch.tokenizers import seq_vqvae as tseq
from egom2p_torch.tokenizers import video_vqvae as tvv
from egom2p_torch.train.vqvae_train import make_grad_vqvae_train_step
from egom2p_tpu.core.schedules import as_optax_schedule
from egom2p_tpu.tokenizers import feature_vqvae as jfv
from egom2p_tpu.tokenizers import seq_vqvae as jseq
from egom2p_tpu.tokenizers import video_vqvae as jvv
from egom2p_tpu.train.vqvae_train import GradVQTrainState
from egom2p_tpu.train.vqvae_train import make_grad_vqvae_train_step as jax_grad_step
from test_torch_vqvae_train import (BETAS, LR, STEPS, WD, _adam_noisy, _close, _jax_adam_nu,
                                    _norm_probe)

torch.set_num_threads(2)

K, D = 16, 8
SEQ = dict(dim=64, depth=2, num_heads=2, latent_dim=D)
VIDEO = dict(num_frames=4, image_size=32, tubelet_t=2, patch_size=8, latent_dim=D, dim=48,
             depth=1, num_heads=4)
FEATURE = dict(latent_dim=D, dim=32, depth=1, num_heads=2)
BATCH = 4
FP32_TOL = 2e-5    # of a tensor's largest magnitude: fp32 sums in another order


@pytest.fixture
def dense(monkeypatch):
    """The port's attention on the dense path, as JAX's CPU einsum."""
    monkeypatch.setattr(port_transformer, "_try_flash64", lambda *a: None)
    monkeypatch.setattr(port_fa, "kernel_head_dim", lambda hd: None)


def pair(kind, quantizer, seed=0):
    """(JAX module, its params, the port's GradVQTokenizer with them, a
    batch maker)."""
    if kind == "cam":
        jcore = jseq.SeqAutoencoder(n_channels=9, **SEQ)
        tcore = tseq.seq_vqvae_from_config("cam", codebook_size=K, **SEQ).net
        x0 = np.zeros((1, 60, 9), np.float32)

        def batch(rng):
            return smooth_cam_trajectories(rng, BATCH)[0].astype(np.float32)
    elif kind == "video":
        jcore = jvv.VideoAutoencoder(n_channels=3, **VIDEO)
        tcore = tvv.video_vqvae_from_config("rgb", codebook_size=K, **VIDEO).net
        x0 = np.zeros((1, 4, 32, 32, 3), np.float32)

        def batch(rng):
            return rng.uniform(-1, 1, (BATCH, 4, 32, 32, 3)).astype(np.float32)
    else:  # a feature core on a 3 x 3 grid of 16-wide features
        jcore = jfv.FeatureAutoencoder(n_channels=16, **FEATURE)
        tcore = tfv.FeatureAutoencoder(16, 3, **FEATURE)
        x0 = np.zeros((1, 3, 3, 16), np.float32)

        def batch(rng):
            return rng.standard_normal((BATCH, 3, 3, 16)).astype(np.float32)
    jm = jseq.GradVQAutoencoder(core=jcore, quantizer_type=quantizer, codebook_size=K,
                                latent_dim=D)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x0))
    tok = tseq.GradVQTokenizer(tseq.GradVQAutoencoder(tcore, quantizer, K, D))
    tok.net.load_state_dict(grad_vqvae_state_dict_from_jax(params, tok))
    return jm, params, tok, batch


@pytest.mark.parametrize("quantizer", ["taming", "memcodes"])
def test_state_dict_is_the_jax_tree(quantizer):
    jm, params, tok, _ = pair("cam", quantizer)
    sd = tok.net.state_dict()
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    assert not any("_codebook" in k for k in sd)
    want = {"taming": {"quantizer.embedding.weight"},
            "memcodes": {"quantizer.codes", "quantizer.to_k", "quantizer.to_v"}}[quantizer]
    assert {k for k in sd if k.startswith("quantizer.")} == want
    assert all(k.startswith(("core.", "quantizer.")) for k in sd)
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["params"]["stray"] = {"kernel": np.zeros((1, 1))}
    with pytest.raises(KeyError):
        grad_vqvae_state_dict_from_jax(bad, tok)


@pytest.mark.parametrize("quantizer", ["taming", "memcodes"])
@pytest.mark.parametrize("kind", ["cam", "video"])
def test_train_steps_match_jax(kind, quantizer, dense):
    jm, params, tok, make_batch = pair(kind, quantizer, seed=1)
    net = tok.net
    sched = cosine_scheduler(LR, 0.0, 1, STEPS, warmup_epochs=0)
    jopt = optax.chain(_norm_probe(), optax.clip_by_global_norm(1.0),
                       optax.adamw(as_optax_schedule(sched), b1=BETAS[0], b2=BETAS[1],
                                   weight_decay=WD))
    opt = Optimizer(net, sched, weight_decay=WD, betas=BETAS, clip_grad=1.0, decay_all=True)
    step = jax.jit(jax_grad_step(jm, jopt, loss_fn="mse", codebook_weight=0.5))
    state = GradVQTrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
    tstep = make_grad_vqvae_train_step(net, opt, "mse", codebook_weight=0.5)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    rng, key = np.random.default_rng(2), jax.random.PRNGKey(5)
    named = dict(net.named_parameters())
    n_tok = int(np.prod(net.core.latent_grid))
    steps, noisy_seen = 0.0, {}
    for i in range(STEPS):
        batch = make_batch(rng)
        key, k = jax.random.split(key)
        state, jmetrics = step(state, jnp.asarray(batch), k)
        noise = (torch.from_numpy(np.array(jax.random.uniform(
            k, (BATCH, 1, n_tok, K), minval=1e-9, maxval=1.0 - 1e-9)))
            if quantizer == "memcodes" else None)
        tmetrics = tstep(torch.from_numpy(batch), noise=noise)
        steps += sched[i]
        for name in ("loss", "reconst_loss", "code_loss", "codebook_usage"):
            _close(float(tmetrics[name]), float(jmetrics[name]), f"step {i} {name}")
        _close(float(tmetrics["grad_norm"]), float(state.opt_state[0]), f"step {i} grad_norm")
        ref = grad_vqvae_state_dict_from_jax(state.params, tok)
        jax_nu = grad_vqvae_state_dict_from_jax(_jax_adam_nu(state.opt_state), tok)
        for name, got in net.state_dict().items():
            noisy = (_adam_noisy(opt.adamw.state[named[name]]["exp_avg_sq"])
                     & _adam_noisy(jax_nu[name])) | noisy_seen.get(name, False)
            noisy_seen[name] = noisy
            _close(got.numpy(), ref[name].numpy(), f"step {i} {name}", noisy, steps)
    for name, v in net.state_dict().items():  # every parameter moved, the codebook too
        assert not torch.equal(v, start[name]), name
    n_noisy = sum(int(v.sum()) for v in noisy_seen.values())
    assert n_noisy < 0.01 * sum(p.numel() for p in named.values())


@pytest.mark.parametrize("quantizer", ["taming", "memcodes"])
def test_feature_decode_tokens_restores_the_grid(quantizer):
    """JAX's GradVQAutoencoder.decode_tokens hands a feature core a flat
    (B, N, D) latent, and FeatureViT unpacks (B, h, w, _): JAX raises.  The
    port decodes on the (h, w) grid: what autoencode_train decodes, and
    JAX's autoencode_train within FP32_TOL."""
    jm, params, tok, make_batch = pair("feature", quantizer)
    x = make_batch(np.random.default_rng(3))
    jtokens = jm.apply(params, jnp.asarray(x), method=jseq.GradVQAutoencoder.tokenize)
    with pytest.raises(ValueError):
        jm.apply(params, jtokens, method=jseq.GradVQAutoencoder.decode_tokens)
    jpred, _, _ = jm.apply(params, jnp.asarray(x), method=jseq.GradVQAutoencoder.autoencode_train)
    tokens = tok.tokenize(x)
    assert tuple(tokens.shape) == (BATCH, 9)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    got = tok.decode_tokens(tokens)
    assert tuple(got.shape) == x.shape
    # autoencode decodes z + (code - z), within an fp32 ulp of the code
    for want in (tok.autoencode(x).numpy(), np.asarray(jpred)):
        scale = float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= FP32_TOL * scale


def _write_clips(root, n, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        np.save(os.path.join(root, f"clip{i}.npy"),
                rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8))
    return str(root)


def _cli_case(domain, tmp_path, monkeypatch):
    """(argv, the tokenize input, the tokens' shape per file)."""
    small = ["--latent_dim", str(D), "--codebook_size", str(K), "--batch_size", "4",
             "--warmup_epochs", "0", "--num_eval_metrics_samples", "8", "--device", "cpu"]
    if domain == "cam":
        data = str(tmp_path / "cam.npy")
        np.save(data, smooth_cam_trajectories(np.random.default_rng(0), 8)[1])
        return (["--domain", "cam", "--data_path", data, "--vq_dim", "64", "--vq_depth", "2",
                 "--vq_heads", "2", *small], data, (8, 30))
    if domain == "rgb":
        data = _write_clips(tmp_path / "clips", 8, 1)
        return (["--domain", "rgb", "--data_path", data, "--use_npy", "--num_frames", "4",
                 "--input_size", "32", "--patch_size", "8", "--tubelet_size", "2",
                 "--vq_dim", "48", "--vq_depth", "1", "--vq_heads", "4", *small], data, (32,))
    spec = tteach.TeacherSpec(name="CLIP-B16", patch=8, width=32, depth=1, heads=2, feat_dim=16,
                              proj=True, ln_pre=True, patch_bias=False, image_size=16)
    monkeypatch.setitem(tteach.TEACHER_SPECS, "CLIP-B16", spec)
    data = str(tmp_path / "imgs.npy")
    np.save(data, np.random.default_rng(2).integers(0, 255, (8, 20, 20, 3), dtype=np.uint8))
    return (["--domain", "CLIP-B16", "--data_path", data, "--teacher_dtype", "fp32",
             "--vq_dim", "32", "--vq_depth", "1", "--vq_heads", "2", *small], data, (8, 4))


@pytest.mark.parametrize("quantizer", ["taming", "memcodes"])
@pytest.mark.parametrize("domain", ["cam", "rgb", "CLIP-B16"])
def test_cli_trains_resumes_evaluates_and_tokenizes(domain, quantizer, tmp_path, monkeypatch):
    argv, data, shape = _cli_case(domain, tmp_path, monkeypatch)
    out = tmp_path / "out"
    argv = argv + ["--quantizer_type", quantizer, "--output_dir", str(out), "--epochs", "2",
                   "--model_ema", "true", "--async_save", "false"]
    res = tcli.main(argv)
    metrics = res["metrics"]
    assert len(metrics) == 4 and all(np.isfinite(v) for m in metrics for v in m.values())
    assert (metrics[0]["code_loss"] > 0) == (quantizer == "taming")  # Memcodes' loss is zero
    log = [json.loads(line) for line in open(out / "log.txt")]
    assert {"eval_loss", "eval_mse", "eval_codebook_usage", "ema_mse"} <= set(log[-1])
    net = res["tokenizer"].net
    assert isinstance(net, tseq.GradVQAutoencoder) and not hasattr(net.core, "quantize")

    # the checkpoint holds the weights and the optimizer bitwise; a resume
    # from it at the same --epochs runs no step and changes nothing
    final = load_pth(str(out / "checkpoint-final.pth"))
    assert final["step"] == 4 and set(final) >= {"model", "optimizer", "model_ema"}
    assert set(final["model"]) == set(net.state_dict())
    loaded = load_vqvae_pth(str(out / "checkpoint-final.pth"), tcli.build_tokenizer(
        tcli.get_args(argv), torch.device("cpu")), "grad")
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.net.state_dict()[k], v), k
    other = tmp_path / "again"
    other.mkdir()
    torch.save(final, other / "checkpoint-final.pth")
    again = tcli.main(argv[:argv.index("--output_dir") + 1] + [str(other)]
                      + argv[argv.index("--output_dir") + 2:])
    assert again["metrics"] == [] and again["optimizer"].step_count == 4
    for k, v in again["tokenizer"].net.state_dict().items():
        assert torch.equal(v, final["model"][k]), k
    moments = again["optimizer"].state_dict()["adamw"]["state"]
    for i, m in final["optimizer"]["adamw"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(moments[i][k], m[k]), (i, k)
    # auto-resume of a longer run from the latest numbered checkpoint (epoch 0)
    more = tcli.main(argv[:argv.index("--epochs") + 1] + ["3"] + argv[argv.index("--epochs") + 2:])
    assert len(more["metrics"]) == 4 and more["optimizer"].step_count == 6

    ckpt = str(out / "checkpoint-final.pth")
    ev = tcli.main(argv + ["--eval_only", "--resume", ckpt])
    assert {"eval_loss", "mse", "codebook_usage"} <= set(ev)
    paths = tcli.main(argv + ["--tokenize", "--resume", ckpt, "--tokenize_path", data,
                              "--tokenize_save_path", str(tmp_path / "tok")])
    path = paths[0] if isinstance(paths, list) else paths
    tokens = np.load(path)["arr_0"]
    assert tokens.shape == shape and tokens.dtype == np.int16
    assert tokens.min() >= 0 and tokens.max() < K
