"""The pretraining path of the PyTorch port against the JAX package.

Same weights (JAX random init moved over by compat/from_jax.py) and the same
numpy inputs go through both at compute_dtype float32.  Attention routes as
in training: every attention of the tiny model at 256 + 256 tokens takes
flash64_train (the port: its plain versions on the CPU; JAX: the Pallas
kernels in interpret mode) and the two 64k-vocab heads take flash CE.  Also
the decoder's mask-gather, one optimizer step, the schedules, the data
pipeline, and a short CPU run of the trainer.
"""
import contextlib
import copy
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import egom2p_torch.models.egom2p as port_egom2p
import egom2p_torch.ops.flash64_train as port_f64t
import egom2p_tpu.ops.flash64_train as jax_f64t
import egom2p_tpu.ops.flash_attention as jax_fa
from egom2p_torch.cli import run_training
from egom2p_torch.compat.from_jax import egom2p_state_dict_from_jax
from egom2p_torch.core import schedules
from egom2p_torch.core.optim import Optimizer, no_decay
from egom2p_torch.data.loader import DatasetStream, MixtureLoader, batch_to_device
from egom2p_torch.data.masking import UnifiedMasking
from egom2p_torch.models.egom2p import create_model
from egom2p_torch.train.egom2p_train import make_train_step
from egom2p_tpu.core import schedules as jax_schedules
from egom2p_tpu.core.optim import create_optimizer as jax_create_optimizer
from egom2p_tpu.data.mixture import DatasetStream as JaxDatasetStream
from egom2p_tpu.data.mixture import MixtureLoader as JaxMixtureLoader
from egom2p_tpu.data.modality_info import MODALITY_INFO as JAX_INFO
from egom2p_tpu.masking.unified import UnifiedMasking as JaxUnifiedMasking
from egom2p_tpu.models.egom2p import create_model as jax_create_model

torch.set_num_threads(2)

MODS4 = ("tok_cam", "tok_depth", "tok_gaze", "tok_rgb")
NAME = "egom2p_tiny_6e_6d_swiglu_nobias"
REPO = pathlib.Path(__file__).resolve().parent.parent
# Loss at float32 through 18 flash64_train attentions, each rounding q/k/v,
# p and its output to bf16 (measured 8.4e-6 relative)
LOSS_RTOL = 1e-4
# Every parameter's gradient, against its max |ref| (measured max 1.0e-2
# over the parameters whose gradients exceed 1e-3)...
GRAD_TOL = 2e-2
# ...but the bf16 roundings inside flash64_train leave an absolute noise
# floor that the JAX package's own kernels show too: on the decoder's
# cross-attention q and query_norm, whose gradients stay below 9e-4, the
# port differs from JAX by at most 2.1e-5 and JAX's interpret kernels from
# JAX's dense path by up to 1.6e-5
GRAD_FLOOR = 5e-5


def make_mod_dict(rng, info, batch=2, inputs=(10, 100, 10, 100), targets=(10, 100, 10, 100)):
    """Per modality (in MODS4 order), `inputs` visible encoder tokens and
    `targets` decoder targets among the rest, at random positions."""
    out = {}
    for m, n_in, n_tgt in zip(MODS4, inputs, targets):
        L, V = info[m]["max_tokens"], info[m]["vocab_size"]
        input_mask = np.ones((batch, L), bool)
        target_mask = np.ones((batch, L), bool)
        for b in range(batch):
            order = rng.permutation(L)
            input_mask[b, order[:n_in]] = False
            target_mask[b, order[n_in:n_in + n_tgt]] = False
        out[m] = {"tensor": rng.integers(0, V, (batch, L)).astype(np.int32),
                  "input_mask": input_mask, "target_mask": target_mask,
                  "decoder_attention_mask": np.zeros((batch, L), np.int32)}
    return out


def to_jax(md):
    return {m: {k: jnp.asarray(v) for k, v in d.items()} for m, d in md.items()}


def to_torch(md):
    return {m: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
            for m, d in md.items()}


def full_info():
    return {m: copy.deepcopy(JAX_INFO[m]) for m in MODS4}


def small_info():
    """Video grids of 2 x 4 x 4 tokens (vocab 96), cam/gaze of 8 (vocab 32):
    dense attention and plain cross-entropy only."""
    from egom2p_tpu.data.modality_info import make_scaled_modality_info
    return make_scaled_modality_info()


def _models(info, n, seed=0):
    jmodel = jax_create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32")
    md = make_mod_dict(np.random.default_rng(seed), info,
                       inputs=(4, 8, 4, 8), targets=(4, 8, 4, 8))
    params = jmodel.init(jax.random.PRNGKey(seed), to_jax(md), n, n)  # dense on the CPU
    tmodel = create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32")
    tmodel.load_state_dict(egom2p_state_dict_from_jax(params, tmodel))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def full_models():
    return _models(full_info(), 256)


@pytest.fixture(scope="module")
def small_models():
    return _models(small_info(), 32)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package's training routing on the CPU: flash64_train through
    its Pallas kernels in interpret mode, flash CE likewise; counts the
    attention calls and makes reaching a stock kernel an error."""
    calls = {"n": 0}
    real = jax_f64t.flash64_train_attention

    def interpret(*a, **kw):
        calls["n"] += 1
        return real(*a, **{**kw, "interpret": True})

    def boom(*a, **kw):
        raise AssertionError("stock flash kernel reached")

    monkeypatch.setattr(jax_f64t, "flash64_train_attention", interpret)
    monkeypatch.setattr(jax_fa, "supports_flash", lambda: True)
    monkeypatch.setattr(jax_fa, "padding_flash_attention", boom)
    monkeypatch.setattr(jax_fa, "segment_flash_attention", boom)
    monkeypatch.setenv("EGOM2P_FLASH_CE", "interpret")
    return calls


@pytest.fixture
def port_calls(monkeypatch):
    """Counts the port's flash64_train and flash CE calls."""
    calls = {"attention": 0, "ce": 0}
    real_attn, real_ce = port_f64t.flash64_train_attention, port_egom2p.flash_ce_total

    def attn(*a, **kw):
        calls["attention"] += 1
        return real_attn(*a, **kw)

    def ce(*a, **kw):
        calls["ce"] += 1
        return real_ce(*a, **kw)

    monkeypatch.setattr(port_f64t, "flash64_train_attention", attn)
    monkeypatch.setattr(port_egom2p, "flash_ce_total", ce)
    return calls


def test_loss_and_every_gradient_match_jax(full_models, jax_kernels, port_calls):
    """Loss, per-modality losses and every parameter's gradient of one
    training forward, kernels routed on both sides."""
    jmodel, params, tmodel = full_models
    md = make_mod_dict(np.random.default_rng(1), tmodel.mod_info)

    def loss_fn(p):
        return jmodel.apply(p, to_jax(md), 256, 256, "mod")

    (j_loss, j_mod), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    assert jax_kernels["n"] == 18  # 6 encoder, 6 decoder self, 6 cross

    tmodel.zero_grad(set_to_none=True)
    loss, mod_loss = tmodel(to_torch(md), 256, 256, "mod")
    loss.backward()
    assert port_calls == {"attention": 18, "ce": 2}

    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    assert set(mod_loss) == set(j_mod) == set(MODS4)
    for m in MODS4:
        np.testing.assert_allclose(mod_loss[m].item(), float(j_mod[m]), rtol=LOSS_RTOL,
                                   err_msg=m)
    ref = egom2p_state_dict_from_jax(j_grads, tmodel)
    params_t = dict(tmodel.named_parameters(remove_duplicate=False))
    assert set(ref) == set(params_t)
    for key, r in ref.items():
        g = params_t[key].grad
        tol = max(GRAD_TOL * r.abs().max().item(), GRAD_FLOOR)
        assert (g - r).abs().max().item() <= tol, key


@pytest.mark.parametrize("with_perm", [False, True])
def test_forward_mask_decoder_matches_jax(small_models, with_perm):
    jmodel, params, tmodel = small_models
    md = make_mod_dict(np.random.default_rng(2), tmodel.mod_info,
                       inputs=(2, 10, 2, 10), targets=(5, 14, 3, 12))
    key = jax.random.PRNGKey(7)

    def probe(m, md):
        return m.forward_mask_decoder(m.embed_decoder(md), 30,
                                      shuffle_rng=key if with_perm else None)

    ref = jmodel.apply(params, to_jax(md), method=probe)
    perm = (torch.from_numpy(np.array(jax.random.permutation(key, 4))) if with_perm
            else None)
    with torch.no_grad():
        got = tmodel.forward_mask_decoder(tmodel.embed_decoder(to_torch(md)), 30, perm)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6)  # tokens
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6)  # emb
    for name, i in (("decoder mask", 2), ("target ids", 3), ("mod ids", 5)):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]), err_msg=name)
    np.testing.assert_array_equal(got[4].segments.numpy(), np.asarray(ref[4].segments))
    if with_perm:  # the permutation moved some modality's block
        plain = tmodel.forward_mask_decoder(tmodel.embed_decoder(to_torch(md)), 30)
        assert not torch.equal(plain[5], got[5])


def test_decoder_rejects_sequence_modalities(small_models):
    _, _, tmodel = small_models
    info = copy.deepcopy(tmodel.mod_info)
    info["tok_cam"]["type"] = "seq_token"
    model = create_model(NAME, MODS4, MODS4, modality_info=info)
    md = to_torch(make_mod_dict(np.random.default_rng(3), tmodel.mod_info,
                                inputs=(2, 4, 2, 4), targets=(2, 4, 2, 4)))
    with pytest.raises(NotImplementedError):
        model.embed_decoder(md)


@pytest.mark.parametrize("loss_type", ["mod", "weighted_mod", "token"])
def test_dense_losses_match_jax(small_models, loss_type):
    """The three loss types on the dense attention and plain cross-entropy
    path, where both packages compute in fp32 (measured 3e-7 relative)."""
    jmodel, params, tmodel = small_models
    md = make_mod_dict(np.random.default_rng(4), tmodel.mod_info,
                       inputs=(3, 8, 3, 8), targets=(4, 8, 4, 8))
    j_loss, j_mod = jmodel.apply(params, to_jax(md), 32, 32, loss_type)
    with torch.no_grad():
        loss, mod_loss = tmodel(to_torch(md), 32, 32, loss_type)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for m in MODS4:
        np.testing.assert_allclose(mod_loss[m].item(), float(j_mod[m]), rtol=1e-5)


def test_optimizer_steps_match_optax(small_models):
    """Two steps of the port's AdamW (two groups, clipping, per-step LR)
    against egom2p_tpu.core.optim.create_optimizer on the same gradients."""
    _, params, tmodel = small_models
    model = copy.deepcopy(tmodel)
    sched = np.array([1e-3, 5e-4])
    rng = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 0.05), params)
        for _ in range(2)]
    opt = jax_create_optimizer(params, jax_schedules.as_optax_schedule(sched),
                               weight_decay=0.05, betas=(0.9, 0.95), clip_grad=1.0)
    state, jparams = opt.init(params), params
    port_opt = Optimizer(model, sched, weight_decay=0.05, betas=(0.9, 0.95), clip_grad=1.0)
    named = dict(model.named_parameters())
    update = jax.jit(lambda g, st, p: opt.update(g, st, p))
    for g in grads:
        updates, state = update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for key, t in egom2p_state_dict_from_jax(g, model).items():
            if key in named:  # the shared mod_emb once
                named[key].grad = t.clone()
        gnorm = port_opt.step()
        np.testing.assert_allclose(gnorm.item(), float(optax.global_norm(g)), rtol=1e-5)
        assert gnorm.item() > 1.0  # the clipping is active
    ref = egom2p_state_dict_from_jax(jparams, model)
    start = egom2p_state_dict_from_jax(params, model)
    for key, t in model.state_dict().items():
        # the same fp32 update in another order: two fp32 ulps of values near 1
        np.testing.assert_allclose(t.numpy(), ref[key].numpy(), rtol=0, atol=2.5e-7,
                                   err_msg=key)
        assert not torch.equal(t, start[key]), key
    decayed = {n for n, p in model.named_parameters() if not no_decay(n, p)}
    assert "mask_token" in decayed and "encoder_embeddings.tok_rgb.mod_emb" in decayed
    assert not any("norm" in n for n in decayed)


@pytest.mark.parametrize("kind,args,warmup", [
    ("cosine", (1e-3, 1e-5, 3, 7), {}),
    ("cosine", (1e-3, 1e-5, 3, 7), {"warmup_steps": 4}),
    ("cosine", (1e-3, 0.0, 2, 5), {"warmup_epochs": 1}),
    ("cosine", (1e-3, 0.0, 1, 6), {"warmup_steps": 305_000}),  # warmup past the end
    ("constant", (3e-4, 2, 5), {}),
    ("inverse_sqrt", (1e-3, 1e-5, 3, 7), {}),
    ("inverse_sqrt", (1e-3, 1e-5, 3, 7), {"warmup_steps": 4, "cooldown_steps": 5}),
    ("inverse_sqrt", (1e-3, 1e-3, 2, 5), {"warmup_epochs": 1}),
])
def test_schedules_match_jax(kind, args, warmup):
    fn = f"{kind}_scheduler"
    np.testing.assert_array_equal(getattr(schedules, fn)(*args, **warmup),
                                  getattr(jax_schedules, fn)(*args, **warmup))


def _synthetic_info(info):
    info = copy.deepcopy(info)
    for m in info:
        info[m]["input_alphas"] = [0.01, 0.1, 1.0, 10.0]
        info[m]["target_alphas"] = [0.01, 0.1, 1.0, 10.0]
    return info


@pytest.mark.parametrize("scaled", [True, False])
def test_masking_and_loader_match_jax(scaled):
    """The port's UnifiedMasking and MixtureLoader draw the JAX package's
    random numbers in its order: one seed gives the same batches."""
    info = _synthetic_info(small_info() if scaled else full_info())
    n_in, n_tgt = (32, 32) if scaled else (2048, 2048)
    rng = np.random.default_rng(0)
    pool = [{m: rng.integers(0, info[m]["vocab_size"], info[m]["max_tokens"]).astype(np.int32)
             for m in MODS4} for _ in range(5)]

    weights = [1.0, 2.0, 1.0, 0.5]
    masking = UnifiedMasking(info, n_in, n_tgt, sampling_weights=weights, seed=3)
    port = iter(MixtureLoader([DatasetStream(lambda: iter(pool), masking)], info, 3, seed=3))
    masking = JaxUnifiedMasking(info, None, n_in, n_tgt, sampling_weights=weights, seed=3)
    ref = iter(JaxMixtureLoader([JaxDatasetStream("s", lambda: iter(pool), masking)], None,
                                info, 3, seed=3))
    for _ in range(3):
        a, b = next(port), next(ref)
        assert a.keys() == b.keys()
        for m in a:
            for k in b[m]:
                np.testing.assert_array_equal(a[m][k], b[m][k], err_msg=f"{m} {k}")
                assert a[m][k].dtype == b[m][k].dtype
    port.close()
    ref.close()
    dev = batch_to_device(a, "cpu")
    assert dev["tok_rgb"]["tensor"].dtype == torch.int32
    assert dev["tok_rgb"]["input_mask"].dtype == torch.bool


def test_masking_rejects_sequence_modalities():
    info = _synthetic_info(small_info())
    info["tok_cam"]["type"] = "seq"
    with pytest.raises(NotImplementedError):
        UnifiedMasking(info, 8, 8, [1.0] * 4)


def test_accumulated_step_equals_one_step(small_models):
    """accum_steps=2 over a batch of 4 gives the loss, the gradient norm and
    the gradients of one step over the same 4 rows: every row holds the same
    target count per modality, so the mean of the two micro-batches'
    per-modality means is the batch's."""
    _, _, tmodel = small_models
    md = to_torch(make_mod_dict(np.random.default_rng(6), tmodel.mod_info, batch=4,
                                inputs=(3, 8, 3, 8), targets=(4, 8, 4, 8)))
    results = []
    for accum in (1, 2):
        model = copy.deepcopy(tmodel)
        opt = Optimizer(model, [1e-3], clip_grad=None)
        results.append((model, make_train_step(model, opt, 32, 32, "mod", accum)(md)))
    (m1, r1), (m2, r2) = results
    assert set(r1) == set(r2) == {"loss", "grad_norm", *(f"loss_{m}" for m in MODS4)}
    for k in r1:
        np.testing.assert_allclose(r2[k].item(), r1[k].item(), rtol=1e-5, err_msg=k)
    for (k, a), b in zip(m1.named_parameters(), m2.parameters()):
        # fp32 sums in another order (measured 5.0e-7 of each gradient's max)
        scale = a.grad.abs().max().item()
        assert (a.grad - b.grad).abs().max().item() <= 1e-5 * scale, k
    with pytest.raises(ValueError):
        make_train_step(m1, Optimizer(m1, [1e-3]), 32, 32, "mod", 3)(md)


def test_trainer_runs_three_cpu_steps(tmp_path):
    """The trainer's synthetic path end to end on the CPU: 3 steps of the
    tiny model on the scaled modalities, a JSON line, a checkpoint."""
    args = run_training.get_args([
        "--synthetic_data", "--scaled_modalities", "--model", NAME,
        "--num_input_tokens", "32", "--num_target_tokens", "32", "--batch_size", "2",
        "--epochs", "1", "--epoch_size", "6", "--lr_schedule", "constant", "--blr", "1e-2",
        "--device", "cpu", "--output_dir", str(tmp_path), "--print_freq", "1"])
    seen = []
    out = run_training.main(args, on_step=lambda step, m, sec: seen.append((step, m, sec)))
    assert [s for s, _, _ in seen] == [0, 1, 2]
    for _, metrics, seconds in seen:
        assert seconds > 0
        assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
        assert set(metrics) >= {"loss", "grad_norm", "loss_tok_rgb", "loss_tok_depth"}
    record = json.loads((tmp_path / "log.txt").read_text().splitlines()[0])
    assert record["epoch"] == 0 and record["tokens_seen_B"] == 3 * 2 * 64 / 1e9
    ckpt = torch.load(tmp_path / "checkpoint-final.pth", weights_only=False)
    assert ckpt["step"] == 3 and set(ckpt["model"]) == set(out["model"].state_dict())
    # the parameters moved away from their seeded initialization
    init = create_model(NAME, MODS4, MODS4, modality_info=small_info())
    init.init_random_(torch.Generator().manual_seed(0))
    moved = [not torch.equal(ckpt["model"][k], v) for k, v in init.state_dict().items()]
    assert sum(moved) > len(moved) // 2


def test_trainer_default_device_raises_without_cuda(tmp_path, monkeypatch):
    """--device defaults to cuda; where no CUDA device is found the trainer
    raises, naming the option, before it loads data or builds a model."""
    import egom2p_torch.models.egom2p as port_models

    def no_build(*a, **k):
        raise AssertionError("no model may be built")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run_training, "setup_data", no_build)
    monkeypatch.setattr(port_models, "create_model", no_build)
    args = run_training.get_args(["--synthetic_data", "--scaled_modalities", "--model", NAME,
                                  "--output_dir", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_training.main(args)
    assert not list(tmp_path.iterdir())


def test_trainer_device_choices():
    """--device takes cuda or cpu, nothing else."""
    assert run_training.get_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        run_training.get_args(["--device", "tpu"])


def test_trainer_args_and_config(tmp_path):
    """The JAX trainer's argument names; --config YAML values become
    defaults, the command line wins; real shards are not ported yet."""
    args = run_training.get_args(["--config", str(REPO / "cfgs/egom2p/main_mod4.yaml"),
                                  "--batch_size", "2"])
    assert (args.model, args.num_input_tokens, args.blr, args.batch_size) == \
        ("egom2p_base_12e_12d_swiglu_nobias", 2048, 1e-4, 2)
    args.lr_schedule, args.epochs, args.epoch_size = "constant", 1, 48
    np.testing.assert_allclose(run_training.lr_schedule(args), np.full(24, 1e-4 * 2 / 256))
    args.synthetic_data = False
    with pytest.raises(NotImplementedError):
        run_training.setup_data(args)


def test_trainer_imports_no_jax():
    """Importing the trainer loads neither JAX nor the JAX package nor
    PyYAML."""
    code = ("import sys\nimport egom2p_torch.cli.run_training as r\n"
            "import egom2p_torch.train.egom2p_train, egom2p_torch.core.optim\n"
            "import egom2p_torch.core.config, egom2p_torch.core.logging\n"
            "import egom2p_torch.data.loader, egom2p_torch.data.masking\n"
            "import egom2p_torch.ops.flash64_train, egom2p_torch.ops.flash_ce\n"
            "r.get_args(['--synthetic_data'])\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'egom2p_tpu', 'yaml') if m in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------- heads of 68 and the kill switches
import egom2p_torch.models.transformer as port_tr  # noqa: E402
import egom2p_torch.ops.attention as port_attn  # noqa: E402
import egom2p_torch.ops.flash64 as port_f64  # noqa: E402
import egom2p_torch.ops.flash_attention as port_fa  # noqa: E402
import egom2p_tpu.models.transformer as jax_tr  # noqa: E402
import egom2p_tpu.ops.attention as jax_attn  # noqa: E402
import egom2p_tpu.ops.flash64 as jax_f64  # noqa: E402

# The tiny model with 3 heads of 68 (dim 204: the 3D sin-cos position
# embedding needs dim % 12 == 0), as EgoM2P-large's 15 heads of 68.  The
# port sends every attention to the stock route (its plain versions, bf16
# roundings of q/k/v, p, dS and the outputs), the JAX package computes
# them densely in fp32 on the CPU.  Measured: losses within 1.3e-5
# relative (LOSS_RTOL), gradients within 7.5e-3 of their max where it
# exceeds 1e-3 (GRAD_TOL) and within 2.6e-5 absolute elsewhere (GRAD_FLOOR)
LARGE_HEADS_OVERRIDES = dict(dim=204, num_heads=3)


@pytest.fixture(scope="module")
def heads68_models():
    info = full_info()
    jmodel = jax_create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32",
                              **LARGE_HEADS_OVERRIDES)
    md = make_mod_dict(np.random.default_rng(0), info, inputs=(4, 8, 4, 8), targets=(4, 8, 4, 8))
    params = jmodel.init(jax.random.PRNGKey(0), to_jax(md), 256, 256)
    tmodel = create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32",
                          **LARGE_HEADS_OVERRIDES)
    tmodel.load_state_dict(egom2p_state_dict_from_jax(params, tmodel))
    return jmodel, params, tmodel


def test_heads_of_68_loss_and_every_gradient_match_jax(heads68_models, port_calls, monkeypatch):
    """3 heads of 68 at 256 + 256 tokens: every attention takes the stock
    route (18 calls: 6 encoder, 6 decoder self, 6 cross; no flash64_train),
    the CE heads the plain path (dim 204 is no multiple of 128, as
    EgoM2P-large's 1020); loss and every gradient against JAX."""
    jmodel, params, tmodel = heads68_models
    stock = []
    real_fwd = port_fa.flash_attention_fwd
    monkeypatch.setattr(port_fa, "flash_attention_fwd",
                        lambda *a, **kw: stock.append(kw["hd"]) or real_fwd(*a, **kw))
    md = make_mod_dict(np.random.default_rng(1), tmodel.mod_info)
    (j_loss, j_mod), j_grads = jax.value_and_grad(
        lambda p: jmodel.apply(p, to_jax(md), 256, 256, "mod"), has_aux=True)(params)

    tmodel.zero_grad(set_to_none=True)
    loss, mod_loss = tmodel(to_torch(md), 256, 256, "mod")
    loss.backward()
    assert stock == [80] * 18 and port_calls == {"attention": 0, "ce": 0}
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    for m in MODS4:
        np.testing.assert_allclose(mod_loss[m].item(), float(j_mod[m]), rtol=LOSS_RTOL,
                                   err_msg=m)
    ref = egom2p_state_dict_from_jax(j_grads, tmodel)
    params_t = dict(tmodel.named_parameters(remove_duplicate=False))
    assert set(ref) == set(params_t)
    for key, r in ref.items():
        tol = max(GRAD_TOL * r.abs().max().item(), GRAD_FLOOR)
        assert (params_t[key].grad - r).abs().max().item() <= tol, key


def _routes(monkeypatch):
    """Spies on every attention kernel entry of both packages; each records
    its name and returns zeros of q's shape."""
    seen = []

    def spy(name):
        def fn(q, *a, **kw):
            seen.append(name)
            return q * 0
        return fn

    for mod, name, label in ((port_f64, "flash64_attention", "flash64"),
                             (port_f64t, "flash64_train_attention", "flash64_train"),
                             (port_fa, "padding_flash_attention", "stock padding"),
                             (port_fa, "segment_flash_attention", "stock segment"),
                             (jax_f64, "flash64_attention", "flash64"),
                             (jax_f64t, "flash64_train_attention", "flash64_train"),
                             (jax_fa, "padding_flash_attention", "stock padding"),
                             (jax_fa, "segment_flash_attention", "stock segment")):
        monkeypatch.setattr(mod, name, spy(label))
    monkeypatch.setattr(jax_fa, "supports_flash", lambda: True)  # the TPU's routing
    return seen


def _route(seen, try_flash64, masked_attention, segment_mask, q, mask, heads):
    """Which kernel one attention call of a model reaches."""
    seen.clear()
    if try_flash64(q, q, q, mask, heads, False) is None:
        split = q.reshape(q.shape[0], q.shape[1], heads, -1).transpose(1, 2) \
            if isinstance(q, torch.Tensor) else q.reshape(q.shape[0], q.shape[1], heads, -1
                                                          ).transpose(0, 2, 1, 3)
        if isinstance(mask, (port_attn.SegmentMask, jax_attn.SegmentMask)):
            mask = segment_mask(mask.segments)
        elif mask is not None:
            mask = mask[:, None]
        masked_attention(split, split, split, mask)
    return seen[0] if seen else "dense"


@pytest.mark.parametrize("env", [{}, {"EGOM2P_FLASH64": "0"}, {"EGOM2P_FLASH64_TRAIN": "0"},
                                 {"EGOM2P_F64T_SEG": "0"},
                                 {"EGOM2P_FLASH64_TRAIN": "0", "EGOM2P_FLASH64": "0"}])
def test_kill_switches_route_as_jax(monkeypatch, env):
    """For every mask kind, head_dim 64 and 68, training and generation, the
    port's _try_flash64 + masked_attention reach the kernel that the JAX
    package's reach, under each kill switch."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = _routes(monkeypatch)
    routes = []
    for generation in (False, True):
        for hd in (64, 68):
            C = 2 * hd
            qt, qj = torch.zeros((2, 256, C)), jnp.zeros((2, 256, C))
            kp_t = torch.zeros((2, 1, 256), dtype=torch.bool)
            kp_j = jnp.zeros((2, 1, 256), bool)
            seg_t = port_attn.SegmentMask(torch.zeros((2, 256), dtype=torch.int32))
            seg_j = jax_attn.SegmentMask(jnp.zeros((2, 256), jnp.int32))
            for kind, mt, mj in (("none", None, None), ("kp", kp_t, kp_j),
                                 ("seg", seg_t, seg_j)):
                ctx_t = port_attn.inference_attention() if generation else contextlib.nullcontext()
                ctx_j = jax_attn.inference_attention() if generation else contextlib.nullcontext()
                with ctx_t:
                    got = _route(seen, port_tr._try_flash64, port_attn.masked_attention,
                                 port_attn.SegmentMask, qt, mt, 2)
                with ctx_j:
                    want = _route(seen, jax_tr._try_flash64, jax_attn.masked_attention,
                                  jax_attn.SegmentMask, qj, mj, 2)
                assert got == want, (generation, hd, kind, got, want)
                routes.append(got)
    if not env:  # training at hd 64: the training kernels; hd 68: the stock route
        assert routes[:6] == ["flash64_train"] * 3 + ["stock padding"] * 2 + ["stock segment"]
    if env.get("EGOM2P_FLASH64_TRAIN") == "0":
        assert "flash64_train" not in routes


def test_ce_switches(full_models, port_calls, monkeypatch):
    """EGOM2P_FLASH_CE=0 sends the 64k heads to the plain chunked CE (the
    same loss); EGOM2P_CE_CHUNK sets flash CE's chunk."""
    _, _, tmodel = full_models
    md = to_torch(make_mod_dict(np.random.default_rng(7), tmodel.mod_info))
    chunks = []
    real = port_egom2p.flash_ce_total
    monkeypatch.setattr(port_egom2p, "flash_ce_total",
                        lambda *a, **kw: chunks.append(kw["chunk"]) or real(*a, **kw))
    with torch.no_grad():
        flash, _ = tmodel(md, 256, 256, "mod")
        monkeypatch.setenv("EGOM2P_CE_CHUNK", "64")
        chunked, _ = tmodel(md, 256, 256, "mod")
        monkeypatch.setenv("EGOM2P_FLASH_CE", "0")
        plain, _ = tmodel(md, 256, 256, "mod")
    assert chunks == [2048, 2048, 64, 64]
    # fp32 logits summed in another order (measured 1.1e-7 relative)
    np.testing.assert_allclose(chunked.item(), flash.item(), rtol=1e-6)
    np.testing.assert_allclose(plain.item(), flash.item(), rtol=1e-6)


def test_plain_ce_rematerialises_its_logits(heads68_models, monkeypatch):
    """The plain CE (the heads of a model whose dim is no multiple of 128)
    keeps no (chunk, V) fp32 logits for the backward: each chunk runs under
    torch.utils.checkpoint and recomputes them, as the JAX package's
    jax.checkpoint around its scan body.  Loss and gradients are those of
    the same CE with the logits kept (the fp32 sums in another order)."""
    _, _, tmodel = heads68_models
    emb = tmodel.decoder_embeddings["tok_rgb"]
    V, D, chunk = emb.vocab_size, 204, 64
    monkeypatch.setenv("EGOM2P_CE_CHUNK", str(chunk))
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.standard_normal((2, 96, D)).astype(np.float32)).requires_grad_()
    ids = torch.from_numpy(rng.integers(0, V, (2, 96)).astype(np.int32))
    weights = torch.from_numpy(rng.uniform(size=(2, 96)) < 0.6)

    saved = []
    tmodel.zero_grad(set_to_none=True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append((tuple(t.shape), t.dtype)) or t, lambda t: t):
        total, count = tmodel._chunked_masked_ce(y, "tok_rgb", ids, weights)
    assert V == 64000 and count.item() == weights.sum().item()
    kept = [s for s, dt in saved if len(s) == 2 and s[1] == V and s[0] != D]
    assert not kept, f"logits-sized tensors saved for the backward: {kept}"
    total.backward()
    got = (total.item(), y.grad.clone(), emb.token_emb.weight.grad.clone())

    # the same CE in one piece, logits kept
    y.grad = None
    tmodel.zero_grad(set_to_none=True)
    logits = emb.forward_logits(y.reshape(-1, D))
    gold = logits.gather(1, ids.reshape(-1).long()[:, None])[:, 0]
    ref = ((torch.logsumexp(logits, dim=-1) - gold) * weights.reshape(-1).float()).sum()
    ref.backward()
    np.testing.assert_allclose(got[0], ref.item(), rtol=1e-6)
    torch.testing.assert_close(got[1], y.grad, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got[2], emb.token_emb.weight.grad, rtol=1e-5, atol=1e-7)

    # and without the checkpoint the hook does see a chunk's logits
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append((tuple(t.shape), t.dtype)) or t, lambda t: t):
        emb.forward_logits(y.reshape(-1, D)[:chunk]).logsumexp(dim=-1).sum()
    assert ((chunk, V), torch.float32) in saved
