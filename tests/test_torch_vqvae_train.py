"""The cam / gaze VQ-VAE's training half on the port against the JAX package,
on the CPU at a small width (dim 64, 2 + 2 blocks, 2 heads, latent 8, 16
codes; 60 frames -> 30 tokens), fp32 in both, the JAX weights carried over
by compat/from_jax.py:

* ops/vq.py:vq_forward against egom2p_tpu.ops.vq.vq_forward, cosine and
  euclidean, both replacement policies, with and without dead-code expiry
  (the replacement draws are the ones JAX takes from its key): indices
  equal, the loss and the new codebook state within VQ_ATOL, the
  straight-through gradient the identity;
* kmeans_init_state on the same permutation;
* the VQ-VAE trainer's optimizer (core/optim.py: every parameter decayed,
  freeze_masked) against run_training_vqvae.py's optax chain on the same
  gradients, to 2.5e-7;
* three train steps (train/vqvae_train.py) against make_vqvae_train_step
  with that chain, for cam (mse) and gaze (mse_mask), plain, with
  --freeze_enc and with the EMA, dead codes expiring from the first step on:
  after every step the metrics, the clip norm and the codebook within
  STEP_RTOL, every parameter and the EMA within STEP_RTOL of its tensor's
  largest magnitude plus ADAM_SHARE of the steps' LR (the bound below);
  frozen tensors bitwise unchanged;
* evaluate_loss / eval_metrics / run_eval_suite (train/vqvae_eval.py) on
  the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import egom2p_tpu.tokenizers.seq_vqvae as jseq
from egom2p_torch.compat.from_jax import seq_vqvae_state_dict_from_jax
from egom2p_torch.core.optim import Optimizer, freeze_masked, freeze_modules_mask
from egom2p_torch.core.schedules import cosine_scheduler
from egom2p_torch.data.cam_gaze import smooth_cam_trajectories, smooth_gaze_tracks
from egom2p_torch.ops import vq as tvq
from egom2p_torch.tokenizers import seq_vqvae as tseq
from egom2p_torch.train import vqvae_eval as teval
from egom2p_torch.train.vqvae_train import init_ema, make_vqvae_train_step, reconst_loss
from egom2p_tpu.core.optim import freeze_masked as jax_freeze_masked
from egom2p_tpu.core.optim import freeze_modules_mask as jax_freeze_modules_mask
from egom2p_tpu.core.schedules import as_optax_schedule
from egom2p_tpu.ops import vq as jvq
from egom2p_tpu.train import vqvae_eval as jeval
from egom2p_tpu.train.vqvae_train import init_train_state, make_vqvae_train_step as jax_step

torch.set_num_threads(2)

SMALL = dict(dim=64, depth=2, num_heads=2, latent_dim=8, codebook_size=16)
K, D = SMALL["codebook_size"], SMALL["latent_dim"]
# the released threshold: coef_ema_dead_code 32 / 256 codes; with decay 0.99
# a code used fewer than 12.5 times in a batch expires at the first step
THRESHOLD = 32.0 / 256
# codebook sums and l2 norms of O(1) latents in another order
VQ_ATOL = 1e-6
# three train steps of both packages, element by element, against each
# tensor's largest magnitude.  Adam divides each gradient by its running RMS,
# so a gradient's fp32 rounding reaches the update scaled by 1 / RMS: where
# the gradient is small the update's share of a step (lr) moves.  Elements
# are held to STEP_RTOL of their tensor's max plus ADAM_SHARE of the steps
# taken (sum of lr); those whose gradient is zero in exact arithmetic or
# within rounding of it (the key bias: softmax ignores a shift shared by all
# keys; Adam RMS under ADAM_NOISE of the tensor's largest in both packages'
# states) are each package's own noise scaled to a step, and held to
# ADAM_STEP_BOUND steps.  The optimizer itself is held to 2.5e-7 on the same
# gradients (test_optimizer_matches_optax); the codebook buffers and the
# metrics to STEP_RTOL.
STEP_RTOL = 1e-5
ADAM_SHARE = 0.01  # 5e-4 the most observed
ADAM_NOISE = 1e-4
ADAM_STEP_BOUND = 0.1  # 0.034 the most observed
BATCH, STEPS, LR, WD, BETAS = 8, 3, 1e-3, 0.05, (0.9, 0.99)
LOSS = {"cam": "mse", "gaze": "mse_mask"}


def make_batch(domain, rng, batch=BATCH):
    """cam (B, 60, 9): smooth standardized paths; gaze (B, 60, 3): smooth
    tracks with a validity channel."""
    if domain == "cam":
        return smooth_cam_trajectories(rng, batch)[0]
    return smooth_gaze_tracks(rng, batch)


def pair(domain, seed=0, **knobs):
    """A JAX tokenizer at SMALL width and the port's with its weights and
    codebook."""
    jt = jseq.seq_vqvae_from_config(domain, jax.random.PRNGKey(seed), **SMALL, **knobs)
    tt = tseq.seq_vqvae_from_config(domain, **SMALL, **knobs)
    tt.net.load_state_dict(seq_vqvae_state_dict_from_jax(jt.params, jt.vq_state, tt))
    return jt, tt


def _vq_case(cosine, seed):
    rng = np.random.default_rng(seed)
    embed = rng.standard_normal((K, D)).astype(np.float32)
    if cosine:
        embed /= np.linalg.norm(embed, axis=-1, keepdims=True)
    cluster = rng.uniform(0, 3, K).astype(np.float32)
    x = (rng.standard_normal((4, 30, D)) * 1.5).astype(np.float32)
    return embed, cluster, x


@pytest.mark.parametrize("policy", ["batch_random", "linde_buzo_gray"])
@pytest.mark.parametrize("cosine", [True, False])
@pytest.mark.parametrize("expire", [True, False])
def test_vq_forward_matches_jax(cosine, policy, expire):
    embed, cluster, x = _vq_case(cosine, 1)
    kw = dict(codebook_size=K, dim=D, decay=0.9, threshold_ema_dead_code=2.0,
              commitment_weight=0.7, use_cosine_sim=cosine, code_replacement_policy=policy)
    jcfg, tcfg = jvq.VQConfig(**kw), tvq.VQConfig(**kw)
    avg = None if cosine else embed * 2.0
    js = jvq.VQState(embed=jnp.asarray(embed), cluster_size=jnp.asarray(cluster),
                     initted=jnp.ones((), bool), embed_avg=None if avg is None else jnp.asarray(avg))
    ts = tvq.VQState(embed=torch.from_numpy(embed), cluster_size=torch.from_numpy(cluster),
                     initted=torch.ones(1), embed_avg=None if avg is None else torch.from_numpy(avg))
    key = jax.random.PRNGKey(7) if expire else None
    jq, jc, ji, jn = jvq.vq_forward(jcfg, js, jnp.asarray(x), training=True, rng=key)
    draws = {}
    if expire and policy == "batch_random":
        draws["replace_idx"] = torch.from_numpy(np.asarray(
            jax.random.randint(key, (K,), 0, x.size // D)))
    elif expire:
        draws["lbg_noise"] = torch.from_numpy(np.asarray(jax.random.normal(key, (K, D))))
    xt = torch.from_numpy(x).requires_grad_(True)
    tq, tc, ti, tn = tvq.vq_forward(tcfg, ts, xt, **draws)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), atol=VQ_ATOL, rtol=0)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-6)
    expired = np.asarray(jn.cluster_size) < 2.0
    assert expired.any() and not expired.all()
    # the expired codes took their replacements, the others the EMA update
    _, _, _, kept = tvq.vq_forward(tcfg, ts, torch.from_numpy(x))
    replaced = (tn.embed != kept.embed).any(-1).numpy()
    np.testing.assert_array_equal(replaced, expired & expire)
    for name in ("embed", "cluster_size") + (() if cosine else ("embed_avg",)):
        np.testing.assert_allclose(getattr(tn, name).numpy(), np.asarray(getattr(jn, name)),
                                   atol=VQ_ATOL, rtol=0, err_msg=name)
    assert (tn.embed_avg is None) == cosine
    # the state it was given is unchanged
    np.testing.assert_array_equal(ts.embed.numpy(), embed)
    # straight-through: the gradient of the output is passed to x as it is
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(x.shape).astype(np.float32))
    (tq * w).sum().backward()
    torch.testing.assert_close(xt.grad, w, rtol=0, atol=0)


@pytest.mark.parametrize("cosine", [True, False])
def test_kmeans_init_matches_jax(cosine):
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((K, D)) * 3
    samples = (centers[rng.integers(0, K, 200)] + rng.standard_normal((200, D)) * 0.3
               ).astype(np.float32)
    kw = dict(codebook_size=K, dim=D, use_cosine_sim=cosine, kmeans_init=True)
    key = jax.random.PRNGKey(3)
    js = jvq.kmeans_init_state(jvq.VQConfig(**kw), jnp.asarray(samples), key)
    perm = torch.from_numpy(np.asarray(jax.random.permutation(key, 200)))
    ts = tvq.kmeans_init_state(tvq.VQConfig(**kw), torch.from_numpy(samples), perm=perm)
    np.testing.assert_array_equal(ts.cluster_size.numpy(), np.asarray(js.cluster_size))
    assert (ts.cluster_size > 0).sum() > K // 2 and bool(ts.initted.all())
    np.testing.assert_allclose(ts.embed.numpy(), np.asarray(js.embed), atol=VQ_ATOL, rtol=0)
    if not cosine:
        np.testing.assert_allclose(ts.embed_avg.numpy(), np.asarray(js.embed_avg), atol=1e-5,
                                   rtol=1e-6)
    # drawn from a generator, and the empty init it fills
    empty = tvq.init_vq_state(tvq.VQConfig(**kw), torch.Generator().manual_seed(0))
    assert not bool(empty.initted.any()) and not bool(empty.embed.any())
    drawn = tvq.kmeans_init_state(tvq.VQConfig(**kw), torch.from_numpy(samples),
                                  generator=torch.Generator().manual_seed(0))
    assert tuple(drawn.embed.shape) == (K, D)


def _norm_probe():
    """An optax transformation that keeps the global norm of the updates it
    passes on (the gradients, first in the chain)."""
    return optax.GradientTransformation(
        lambda params: jnp.zeros(()), lambda u, s, params=None: (u, optax.global_norm(u)))


def _close(got, want, what, noisy=None, steps=0.0):
    """|got - want| against the tensor's largest |want|: within STEP_RTOL of
    it, plus ADAM_SHARE of `steps` (the sum of the LRs so far) for the
    elements of a parameter, plus ADAM_STEP_BOUND of it where `noisy` marks
    an element within Adam's noise.  Returns (the largest error over the
    tensor's max, the largest excess in LR steps, the noisy elements, their
    largest excess in LR steps)."""
    scale = max(float(np.abs(want).max()), 1e-30)
    diff = np.abs(np.asarray(got, np.float64) - want)
    excess = diff - STEP_RTOL * scale
    noisy_share = 0.0
    if noisy is not None and noisy.any():
        noisy_share = float(excess[noisy].max()) / steps
        assert noisy_share <= ADAM_STEP_BOUND, \
            f"{what}: an element within Adam's noise off by {noisy_share:.3f} steps"
        excess = np.where(noisy, 0.0, excess)
    share = float(excess.max()) / steps if steps else 0.0
    assert excess.max() <= ADAM_SHARE * steps, \
        f"{what}: off by {diff.max():.3e} ({diff.max() / scale:.2e} of its max, {share:.3f} steps)"
    return (float(diff.max()) / scale, share, 0 if noisy is None else int(noisy.sum()),
            noisy_share)


def _adam_noisy(nu):
    """Elements whose Adam RMS (the square root of the second moments `nu`)
    is under ADAM_NOISE of the tensor's largest."""
    rms = torch.as_tensor(nu).sqrt()
    return (rms < ADAM_NOISE * rms.max()).numpy()


def _jax_adam_nu(opt_state):
    """The second moments of the Adam state within an optax chain's state."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam.nu


@pytest.mark.parametrize("freeze", [False, True])
def test_optimizer_matches_optax(freeze):
    """Two steps of the VQ-VAE trainer's optimizer (every parameter decayed,
    clipping, per-step LR; --freeze_enc's freeze_masked after AdamW) against
    run_training_vqvae.py:633-641's optax chain on the same gradients."""
    jt, tt = pair("cam", seed=4)
    sched = np.array([1e-3, 5e-4])
    rng = np.random.default_rng(8)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 0.05),
        jt.params) for _ in range(2)]
    chain = optax.chain(optax.clip_by_global_norm(1.0),
                        optax.adamw(as_optax_schedule(sched), b1=BETAS[0], b2=BETAS[1],
                                    weight_decay=WD))
    opt = Optimizer(tt.net, sched, weight_decay=WD, betas=BETAS, clip_grad=1.0, decay_all=True)
    assert all(g["weight_decay"] == WD for g in opt.adamw.param_groups if g["params"])
    frozen = {}
    if freeze:
        chain = optax.chain(chain, jax_freeze_masked(jax_freeze_modules_mask(
            jt.params, ("encoder", "quant_proj"))))
        frozen = freeze_modules_mask(tt.net)
        freeze_masked(frozen, opt, tt.net)
    start = {k: v.clone() for k, v in tt.net.named_parameters()}
    state, jparams = chain.init(jt.params), jt.params
    named = dict(tt.net.named_parameters())
    for g in grads:
        updates, state = jax.jit(chain.update)(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for key, t in seq_vqvae_state_dict_from_jax(g, jt.vq_state, tt).items():
            if key in named:
                named[key].grad = t.clone()
        gnorm = opt.step()
        # the frozen gradients count in the clip norm
        np.testing.assert_allclose(gnorm.item(), float(optax.global_norm(g)), rtol=1e-5)
        assert gnorm.item() > 1.0  # the clipping is active
    ref = seq_vqvae_state_dict_from_jax(jparams, jt.vq_state, tt)
    for key, t in named.items():
        # the same fp32 update in another order: two fp32 ulps of values near 1
        np.testing.assert_allclose(t.detach().numpy(), ref[key].numpy(), rtol=0, atol=2.5e-7,
                                   err_msg=key)
        assert torch.equal(t, start[key]) == bool(frozen.get(key)), key
    if freeze:  # Adam's moments of the frozen parameters still accumulate
        assert bool(opt.adamw.state[named["encoder.conv.weight"]]["exp_avg"].any())


@pytest.mark.parametrize("variant", ["plain", "freeze_enc", "ema"])
@pytest.mark.parametrize("domain", ["cam", "gaze"])
def test_train_steps_match_jax(domain, variant):
    jt, tt = pair(domain, seed=1, threshold_ema_dead_code=THRESHOLD)
    sched = cosine_scheduler(LR, 0.0, 1, STEPS, warmup_epochs=0)
    jopt = optax.chain(_norm_probe(), optax.clip_by_global_norm(1.0),
                       optax.adamw(as_optax_schedule(sched), b1=BETAS[0], b2=BETAS[1],
                                   weight_decay=WD))
    opt = Optimizer(tt.net, sched, weight_decay=WD, betas=BETAS, clip_grad=1.0, decay_all=True)
    if variant == "freeze_enc":
        jopt = optax.chain(jopt, jax_freeze_masked(jax_freeze_modules_mask(
            jt.params, ("encoder", "quant_proj"))))
        frozen = freeze_modules_mask(tt.net)
        freeze_masked(frozen, opt, tt.net)
        assert {k for k, v in frozen.items() if v} == {
            k for k in frozen if k.startswith(("encoder.", "quant_proj."))}
        start = {k: v.clone() for k, v in tt.net.state_dict().items()}
    ema_decay = 0.9 if variant == "ema" else None
    step = jax.jit(jax_step(jt.module, jt.vq_cfg, jopt, loss_fn=LOSS[domain],
                            ema_decay=ema_decay, ema_update_freq=2))
    state = init_train_state(jt.params, jopt, jt.vq_state, use_ema=ema_decay is not None)
    ema = init_ema(tt.net) if ema_decay else None
    tstep = make_vqvae_train_step(tt.net, opt, LOSS[domain], ema=ema, ema_decay=ema_decay,
                                  ema_update_freq=2)
    rng, key = np.random.default_rng(2), jax.random.PRNGKey(5)
    params = dict(tt.net.named_parameters())
    worst, share, noisy_max, noisy_share, steps = 0.0, 0.0, 0, 0.0, 0.0
    for i in range(STEPS):
        batch = make_batch(domain, rng)
        key, k = jax.random.split(key)
        state, jm = step(state, jnp.asarray(batch), k)
        idx = torch.from_numpy(np.array(jax.random.randint(k, (K,), 0, BATCH * 30)))
        tm = tstep(torch.from_numpy(batch), replace_idx=idx)
        steps += sched[i]
        if i == 0:  # the released threshold expires codes from the first step on
            assert (np.asarray(state.vq_state.cluster_size) < THRESHOLD).any()
        probe = state.opt_state[0][0] if variant == "freeze_enc" else state.opt_state[0]
        for name, want in (*((n, float(jm[n])) for n in ("loss", "reconst_loss", "code_loss",
                                                          "codebook_usage")),
                           ("grad_norm", float(probe))):
            worst = max(worst, _close(float(tm[name]), want, f"step {i} {name}")[0])
        ref = seq_vqvae_state_dict_from_jax(state.params, state.vq_state, tt)
        ref_ema = (seq_vqvae_state_dict_from_jax(state.ema_params, state.vq_state, tt)
                   if ema is not None else {})
        # within Adam's noise: where both packages' second moments say so
        jax_nu = seq_vqvae_state_dict_from_jax(_jax_adam_nu(state.opt_state), state.vq_state, tt)
        n_noisy = 0
        for name, got in tt.net.state_dict().items():
            noisy = (_adam_noisy(opt.adamw.state[params[name]]["exp_avg_sq"])
                     & _adam_noisy(jax_nu[name]) if name in params else None)
            checks = [(got, ref[name], name)]
            if name in params and ema is not None:
                checks.append((ema[name], ref_ema[name], f"ema {name}"))
            for t, r, what in checks:
                e, sh, n, nsh = _close(t.numpy(), r.numpy(), f"step {i} {what}", noisy,
                                  steps if name in params else 0.0)
                worst, share, noisy_share = max(worst, e), max(share, sh), max(noisy_share, nsh)
            n_noisy += n
        noisy_max = max(noisy_max, n_noisy)
    n_params = sum(p.numel() for p in params.values())
    print(f"{domain} {variant}: {share:.4f} of the steps' size past {STEP_RTOL} of a tensor's "
          f"max at worst; {noisy_max} of {n_params} elements within Adam's noise, "
          f"{noisy_share:.3f} steps off at worst")
    assert noisy_max < 0.01 * n_params
    if variant == "freeze_enc":
        for name, v in tt.net.named_parameters():
            assert torch.equal(v, start[name]) == frozen[name], name
        for name in ("embed", "cluster_size"):  # the codebook still learns
            name = f"quantize._codebook.{name}"
            assert not torch.equal(tt.net.state_dict()[name], start[name])


@pytest.mark.parametrize("domain", ["cam", "gaze"])
def test_evaluate_loss_and_metrics_match_jax(domain):
    jt, tt = pair(domain, seed=3)
    data = make_batch(domain, np.random.default_rng(6), batch=20)
    n_channels = 9 if domain == "cam" else 2
    jl = jeval.evaluate_loss(jt, data, LOSS[domain], 1.0, 8, n_channels, limit=18)
    tl = teval.evaluate_loss(tt, data, LOSS[domain], 1.0, 8, n_channels, limit=18)
    jm = jeval.eval_metrics(jt, data, domain, K, 8, limit=18)
    tm = teval.eval_metrics(tt, data, domain, K, 8, limit=18)
    assert tl.keys() == jl.keys() and tm.keys() == jm.keys()
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-5, err_msg=k)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    # the suite: the EMA pass swaps the EMA weights in and puts the live ones back
    before = {k: v.clone() for k, v in tt.net.state_dict().items()}
    ema = {k: v * 0.5 for k, v in tt.net.named_parameters()}
    out = teval.run_eval_suite(tt, data, domain, K, LOSS[domain], 1.0, 8, limit=18, ema=ema)
    assert {f"ema_{k}" for k in jm} <= set(out) and out["mse"] == tm["mse"]
    assert out["ema_mse"] != out["mse"]
    for k, v in tt.net.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(ValueError, match="unknown eval domain"):
        teval.eval_metrics(tt, data, "bogus", K, 8)


def test_smooth_gaze_tracks_are_gaze_tokenizer_inputs():
    x = smooth_gaze_tracks(np.random.default_rng(0), 64)
    assert x.shape == (64, 60, 3) and x.dtype == np.float32
    valid = x[..., 2]
    assert set(np.unique(valid)) == {0.0, 1.0} and 0.7 < valid.mean() < 0.95
    assert (x[..., :2][valid == 0] == 0).all() and np.abs(x[..., :2]).max() <= 1.0
    # smooth: a frame's step is small against the track's range
    steps = np.abs(np.diff(x[..., :2], axis=1))[(valid[:, 1:] * valid[:, :-1]) > 0]
    assert np.median(steps) < 0.1
    np.testing.assert_array_equal(x, smooth_gaze_tracks(np.random.default_rng(0), 64))


@pytest.mark.slow
def test_gaze_train_steps_match_jax_at_the_released_width(capsys):
    """Six gaze steps at the released width (dim 768, 12 + 12 blocks, 256
    codes, threshold 32 / 256) and optimizer (the config's betas, weight
    decay, warmup from 1e-6) at B = 32: the four metrics within 1e-4 of
    JAX's every step.  The losses swing in both packages alike (the codes
    expire and are replaced at the first steps); the printout is the record."""
    knobs = dict(threshold_ema_dead_code=THRESHOLD)
    jt = jseq.seq_vqvae_from_config("gaze", jax.random.PRNGKey(0), **knobs)
    tt = tseq.seq_vqvae_from_config("gaze", **knobs)
    tt.net.load_state_dict(seq_vqvae_state_dict_from_jax(jt.params, jt.vq_state, tt))
    batch_size, steps = 32, 6
    sched = cosine_scheduler(5e-5 * batch_size / 256, 0.0, 1, steps, warmup_epochs=5,
                             start_warmup_value=1e-6)
    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(as_optax_schedule(sched), b1=0.9, b2=0.99, weight_decay=1e-4))
    opt = Optimizer(tt.net, sched, weight_decay=1e-4, betas=(0.9, 0.99), clip_grad=1.0,
                    decay_all=True)
    step = jax.jit(jax_step(jt.module, jt.vq_cfg, jopt, loss_fn="mse_mask"))
    state = init_train_state(jt.params, jopt, jt.vq_state)
    tstep = make_vqvae_train_step(tt.net, opt, "mse_mask")
    rng, key = np.random.default_rng(0), jax.random.PRNGKey(1)
    for i in range(steps):
        batch = smooth_gaze_tracks(rng, batch_size)
        key, k = jax.random.split(key)
        state, jm = step(state, jnp.asarray(batch), k)
        idx = torch.from_numpy(np.array(jax.random.randint(k, (256,), 0, batch_size * 30)))
        tm = tstep(torch.from_numpy(batch), replace_idx=idx)
        with capsys.disabled():
            print(f"step {i}: " + ", ".join(f"{n} {float(tm[n]):.4f} / {float(jm[n]):.4f}"
                                          for n in jm))
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-4, err_msg=name)
