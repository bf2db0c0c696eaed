"""The trainer on token shards, against the JAX package: setup_data and
setup_val_data, the eval step, freeze_until, activation checkpointing,
register tokens and drop-path (egom2p_torch/cli/run_training.py,
train/egom2p_train.py, core/optim.py, models/{egom2p,transformer}.py), and
a CPU run of the trainer on shards with workers, evaluation, a frozen
trunk and a resume.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import egom2p_torch.data.loader as port_loader
import egom2p_torch.ops.flash64_train as port_f64t
import run_training_egom2p as jax_trainer
from egom2p_torch.cli import run_training
from egom2p_torch.compat.from_jax import egom2p_state_dict_from_jax
from egom2p_torch.core.checkpoint import load_egom2p_pth, save_checkpoint
from egom2p_torch.core.optim import Optimizer, freeze_until, shared_params_mask
from egom2p_torch.data.modality_info import MODALITY_INFO
from egom2p_torch.models.egom2p import create_model
from egom2p_torch.models.transformer import Block
from egom2p_torch.train.egom2p_train import make_eval_step
from egom2p_tpu.compat.torch_convert import load_egom2p_pth as jax_load_pth
from egom2p_tpu.core import schedules as jax_schedules
from egom2p_tpu.core.mesh import make_mesh
from egom2p_tpu.core.optim import create_optimizer as jax_create_optimizer
from egom2p_tpu.core.optim import freeze_until as jax_freeze_until
from egom2p_tpu.core.optim import shared_params_mask as jax_shared_params_mask
from egom2p_tpu.models.egom2p import create_model as jax_create_model
from egom2p_tpu.train.egom2p_train import make_eval_step as jax_make_eval_step
from tests.test_torch_data_shards import assert_batches_equal, shard_args, write_tree
from tests.test_torch_train import (LOSS_RTOL, MODS4, NAME, full_info, small_info, to_jax,
                                    to_torch)

torch.set_num_threads(2)
MODS2 = ("tok_cam", "tok_rgb")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    pattern, train = write_tree(root, "set", 3, 4, seed=0)
    val_pattern, val = write_tree(root, "held_out", 1, 4, seed=1)
    return pattern, train, val_pattern, val


def make_mod_dict(info, seed, n_in=4, n_tgt=8, batch=2):
    """Per modality of `info`, `n_in` visible tokens and `n_tgt` targets
    among the rest, at random positions."""
    rng = np.random.default_rng(seed)
    out = {}
    for m in sorted(info):
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


def _pair(info, n, depth=2, domains=MODS4, seed=0, **kw):
    """The tiny model at `depth` + `depth` blocks in both packages at
    float32, the JAX weights carried over."""
    jmodel = jax_create_model(NAME, domains, domains, modality_info=info,
                              compute_dtype="float32", encoder_depth=depth,
                              decoder_depth=depth, **kw)
    md = make_mod_dict({m: info[m] for m in domains}, seed)
    params = jax.jit(lambda k: jmodel.init(k, to_jax(md), n, n))(jax.random.PRNGKey(seed))
    tmodel = create_model(NAME, domains, domains, modality_info=info, compute_dtype="float32",
                          encoder_depth=depth, decoder_depth=depth, **kw)
    tmodel.load_state_dict(egom2p_state_dict_from_jax(params, tmodel))
    return jmodel, params, tmodel


def _keys(batch, samples):
    """The sample keys of a batch's rows, by their tok_cam tokens."""
    key_of = {v["tok_cam"].tobytes(): k for k, v in samples.items()}
    return [key_of.get(row.tobytes()) for row in batch["tok_cam"]["tensor"]]


def test_setup_data_and_val_data_match_jax(trees, tmp_path):
    """On one tar tree and data config both trainers give equal train
    batches, equal val and fixed-eval batches; two fixed-eval passes are
    bitwise identical; the val samples are the held-out shard's only."""
    pattern, train, val_pattern, val = trees
    port_args, jax_args = shard_args(tmp_path, pattern, val_pattern=val_pattern)
    mesh = make_mesh(devices=jax.devices()[:1])
    (port, port_domains), (ref, ref_domains) = (run_training.setup_data(port_args),
                                                jax_trainer.setup_data(jax_args, mesh))
    assert port_domains == ref_domains == list(MODS2)
    a, b = iter(port), iter(ref)
    for _ in range(3):
        batch = next(a)
        assert_batches_equal(batch, next(b))
        assert None not in _keys(batch, train)
    a.close()
    b.close()
    port_val, port_fixed = run_training.setup_val_data(port_args)
    ref_val, ref_fixed = jax_trainer.setup_val_data(jax_args, mesh)
    assert list(port_val) == list(ref_val) == ["set"] and list(port_fixed) == ["set"]
    passes = []
    for factories, refs in ((port_val, ref_val), (port_fixed, ref_fixed),
                            (port_fixed, ref_fixed)):
        a, b = factories["set"](), refs["set"]()
        passes.append([next(a) for _ in range(2)])
        for batch in passes[-1]:
            assert_batches_equal(batch, next(b))
            assert None not in _keys(batch, val) and set(_keys(batch, train)) == {None}
        a.close()
    for x, y in zip(passes[1], passes[2]):
        assert_batches_equal(x, y)
    for batch in passes[1]:  # fixed eval: budgets of 128, cut where a modality runs out
        n_in = sum((~batch[m]["input_mask"]).sum(axis=1) for m in MODS2)
        n_tgt = sum((~batch[m]["target_mask"]).sum(axis=1) for m in MODS2)
        assert (n_in <= 128).all() and (n_tgt <= 128).all() and 128 in n_in


def test_synthetic_val_pool_matches_jax_and_is_held_out():
    argv = ["--synthetic_data", "--scaled_modalities", "--batch_size", "2",
            "--num_input_tokens", "16", "--num_target_tokens", "16"]
    port_args, jax_args = run_training.get_args(argv), jax_trainer.get_args(argv)
    mesh = make_mesh(devices=jax.devices()[:1])
    port_val, port_fixed = run_training.setup_val_data(port_args)
    ref_val, ref_fixed = jax_trainer.setup_val_data(jax_args, mesh)
    train_it = iter(run_training.setup_data(port_args)[0])
    train_rows = {r.tobytes() for _ in range(40) for r in next(train_it)["tok_rgb"]["tensor"]}
    train_it.close()
    for port, ref in ((port_val, ref_val), (port_fixed, ref_fixed)):
        a, b = port["synthetic_val"](), ref["synthetic_val"]()
        for _ in range(2):
            batch = next(a)
            assert_batches_equal(batch, next(b))
            assert not {r.tobytes() for r in batch["tok_rgb"]["tensor"]} & train_rows
        a.close()


@pytest.fixture(scope="module")
def eval_models():
    """The tiny model at 2 + 2 blocks on tok_cam and tok_rgb at full width."""
    return _pair({m: full_info()[m] for m in MODS2}, 128, domains=MODS2)


@pytest.mark.parametrize("loss_type", ["mod", "token"])
def test_eval_step_matches_jax(eval_models, trees, tmp_path, loss_type):
    """make_eval_step's losses at float32 on a fixed-eval batch of the
    held-out shards (128 + 128 tokens: dense attention in both packages)."""
    jmodel, params, tmodel = eval_models
    pattern, _, val_pattern, _ = trees
    port_args, _ = shard_args(tmp_path, pattern, val_pattern=val_pattern)
    it = run_training.setup_val_data(port_args)[1]["set"]()
    raw = next(it)
    it.close()
    ref = jax.jit(jax_make_eval_step(jmodel, 128, 128, loss_type))(params, to_jax(raw))
    calls = []
    real = port_f64t.flash64_train_attention
    port_f64t.flash64_train_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        tmodel.train()
        got = make_eval_step(tmodel, 128, 128, loss_type)(to_torch(raw))
        again = make_eval_step(tmodel, 128, 128, loss_type)(to_torch(raw))
    finally:
        port_f64t.flash64_train_attention = real
    assert not calls  # 128 x 128 < 256^2: the dense path
    assert not tmodel.training
    assert set(got) == set(ref) == {"loss", "loss_tok_cam", "loss_tok_rgb"}
    for k in got:
        assert not got[k].requires_grad
        assert torch.equal(got[k], again[k])
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=LOSS_RTOL, err_msg=k)


def test_freeze_until_matches_optax():
    """Three steps with the trunk frozen for two, against optax's
    freeze_until(shared_params_mask): the parameters after each step within
    test_optimizer_steps_match_optax's tolerance, the trunk unchanged and
    its Adam moments zero while frozen, moved after."""
    _, params, model = _pair(small_info(), 32)
    mask = shared_params_mask(model)
    ref_mask = egom2p_state_dict_from_jax(jax.tree_util.tree_map(
        lambda frozen, p: np.full(p.shape, frozen, np.float32),
        jax_shared_params_mask(params), params), model)
    assert {k: bool(v.flatten()[0]) for k, v in ref_mask.items() if k in mask} == mask
    trunk = {k for k, v in mask.items() if v}
    assert "decoder_proj_context.weight" not in trunk and "encoder_norm.weight" in trunk
    assert "encoder.0.attn.qkv.weight" in trunk and "mask_token" not in trunk
    sched = np.array([1e-3, 5e-4, 4e-4])
    rng = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 0.05), params)
        for _ in range(3)]
    opt = jax_freeze_until(2, jax_shared_params_mask(params), jax_create_optimizer(
        params, jax_schedules.as_optax_schedule(sched), weight_decay=0.05,
        betas=(0.9, 0.95), clip_grad=1.0))
    state, jparams = opt.init(params), params
    port_opt = freeze_until(2, mask, Optimizer(model, sched, weight_decay=0.05,
                                               betas=(0.9, 0.95), clip_grad=1.0), model)
    named = dict(model.named_parameters())
    start = {k: v.clone() for k, v in model.state_dict().items()}
    update = jax.jit(lambda g, st, p: opt.update(g, st, p))
    for i, g in enumerate(grads):
        updates, state = update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for key, t in egom2p_state_dict_from_jax(g, model).items():
            if key in named:
                named[key].grad = t.clone()
        gnorm = port_opt.step()
        trainable = optax.global_norm(jax.tree_util.tree_map(
            lambda x, frozen: x * 0 if frozen and i < 2 else x, g,
            jax_shared_params_mask(params)))
        np.testing.assert_allclose(gnorm.item(), float(trainable), rtol=1e-5)
        ref = egom2p_state_dict_from_jax(jparams, model)
        for key, t in model.state_dict().items():
            np.testing.assert_allclose(t.numpy(), ref[key].numpy(), rtol=0, atol=2.5e-7,
                                       err_msg=f"step {i} {key}")
            if key in trunk:
                assert torch.equal(t, start[key]) == (i < 2), (i, key)
                moments = port_opt.adamw.state[named[key]]
                assert bool((moments["exp_avg"] == 0).all()) == (i < 2), (i, key)
            else:
                assert not torch.equal(t, start[key]), key
    assert port_opt.step_count == 3


def _narrow_vocab_info():
    """The released grids (the attention at 256 + 256 tokens takes the
    kernels' route) with 1024-token vocabularies (a cheap CE on the CPU)."""
    info = full_info()
    for m in info:
        info[m]["vocab_size"] = info[m]["embed_spec"]["vocab_size"] = min(
            1024, info[m]["vocab_size"])
    return info


def _remat_model(policy, **kw):
    use = policy != "none"
    model = create_model(NAME, MODS4, MODS4, modality_info=_narrow_vocab_info(),
                         compute_dtype="float32",
                         use_act_checkpoint=use, remat_policy="full" if not use else policy,
                         encoder_depth=2, decoder_depth=2, **kw)
    return model.init_random_(torch.Generator().manual_seed(0))


def test_remat_policies_give_identical_loss_and_gradients(monkeypatch):
    """none / full / dots at float32, with stochastic depth on: the same
    loss and every gradient bitwise (the masks are drawn outside the
    recomputed blocks); under both remat policies the attention kernel's
    forward runs again in the backward (12 calls instead of 6 at 2 + 2
    blocks)."""
    calls = {"n": 0}
    real = port_f64t.flash64_train_fwd

    def fwd(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(port_f64t, "flash64_train_fwd", fwd)
    md = to_torch(make_mod_dict(_narrow_vocab_info(), 1, n_in=60, n_tgt=60))
    results = {}
    for policy in ("none", "full", "dots"):
        model = _remat_model(policy, drop_path_rate_encoder=0.3, drop_path_rate_decoder=0.2)
        calls["n"] = 0
        loss, _ = model(md, 256, 256, "mod", shuffle=torch.Generator().manual_seed(4))
        loss.backward()
        results[policy] = (loss.detach(), calls["n"],
                           {k: p.grad for k, p in model.named_parameters()})
    loss0, n0, g0 = results["none"]
    assert n0 == 6
    for policy in ("full", "dots"):
        loss, n, grads = results[policy]
        assert n == 12, policy
        assert torch.equal(loss, loss0), policy
        for k, g in g0.items():
            assert torch.equal(grads[k], g), (policy, k)


def test_register_tokens_match_jax(tmp_path):
    """num_register_tokens=2: the encoder context (registers included) and
    the loss match JAX at float32 on the dense path; the register_tokens
    key goes through from_jax, and through .pth files both packages read."""
    info = small_info()
    jmodel, params, tmodel = _pair(info, 32, seed=1, num_register_tokens=2)
    md = make_mod_dict(info, 3)
    assert tmodel.state_dict()["register_tokens"].shape == (1, 2, 384)
    ref_ctx, ref_mask, ref_loss = jax.jit(lambda p, d: (
        *jmodel.apply(p, d, 32, method=lambda m, d, n: m.forward_enc_context(d, n)),
        jmodel.apply(p, d, 32, 32, "mod")[0]))(params, to_jax(md))
    with torch.no_grad():
        ctx, mask = tmodel.forward_enc_context(to_torch(md), 32)
        loss, _ = tmodel.eval()(to_torch(md), 32, 32, "mod")
    assert ctx.shape == (2, 34, 384)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert not mask[:, :, :2].any()  # the registers are live keys
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ref_ctx), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    path = save_checkpoint(str(tmp_path), "final", tmodel)
    np.testing.assert_array_equal(np.asarray(jax_load_pth(path, jmodel)["params"]
                                             ["register_tokens"]),
                                  np.asarray(params["params"]["register_tokens"]))
    other = create_model(NAME, MODS4, MODS4, modality_info=info, num_register_tokens=2,
                         encoder_depth=2, decoder_depth=2)
    assert torch.equal(load_egom2p_pth(path, other).register_tokens, tmodel.register_tokens)


def test_drop_path_is_identity_in_eval_and_per_sample_in_training():
    torch.manual_seed(0)
    rate = 0.25
    blk = Block(64, 1, drop_path=rate).eval()
    x = torch.randn(3, 5, 64)
    keep = torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]])
    with torch.no_grad():
        plain = Block(64, 1)
        plain.load_state_dict(blk.state_dict())
        assert torch.equal(blk(x), plain(x))
        h1 = blk.attn(blk.norm1(x))
        x1 = x + h1 / (1 - rate) * keep[0][:, None, None]
        want = x1 + blk.mlp(blk.norm2(x1)) / (1 - rate) * keep[1][:, None, None]
        got = blk(x, None, keep)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(got[1, :, :], (x + blk.mlp(blk.norm2(x)) / (1 - rate))[1])
    model = create_model(NAME, MODS4, MODS4, modality_info=small_info(),
                         drop_path_rate_encoder=0.3, drop_path_rate_decoder=0.1)
    assert [b.drop_path for b in model.encoder] == np.linspace(0, 0.3, 6).tolist()
    assert [b.drop_path for b in model.decoder] == np.linspace(0, 0.1, 6).tolist()
    gen = torch.Generator().manual_seed(7)
    masks = [model._keep_masks(b, 2, 4, gen, "cpu") for b in model.encoder]
    assert masks[0] is None and all(m.shape == (2, 4) for m in masks[1:])
    model.eval()
    assert model._keep_masks(model.encoder[5], 2, 4, gen, "cpu") is None


def test_trainer_on_shards_with_eval_frozen_trunk_and_resume(tmp_path, monkeypatch):
    """2 epochs x 3 steps on the test's shards with 2 forked workers, eval
    over 2 batches, the trunk frozen in epoch 0: log.txt holds the val_* and
    fixed_eval_* losses, the trunk is unchanged after epoch 0 and moved
    after epoch 1; a resumed run reads no replayed batch.  tok_rgb's
    vocabulary is cut to 1024 here (its tokens written below it) to keep the
    CPU run short; its 5 x 32 x 32 grid stays."""
    vocab = {"tok_rgb": 1024, "tok_cam": 256}
    small_rgb = copy.deepcopy(MODALITY_INFO["tok_rgb"])
    small_rgb["vocab_size"] = small_rgb["embed_spec"]["vocab_size"] = 1024
    monkeypatch.setitem(MODALITY_INFO, "tok_rgb", small_rgb)
    pattern, _ = write_tree(tmp_path / "shards", "set", 3, 4, seed=0, vocab=vocab)
    val_pattern, _ = write_tree(tmp_path / "shards", "held_out", 1, 4, seed=1, vocab=vocab)
    out = tmp_path / "out"
    argv = ["--model", NAME, "--batch_size", "2", "--num_input_tokens", "32",
            "--num_target_tokens", "32", "--epochs", "2", "--epoch_size", "6",
            "--lr_schedule", "constant", "--blr", "1e-2", "--device", "cpu",
            "--output_dir", str(out), "--num_workers", "2", "--eval_iters", "2",
            "--frozen_model_epochs", "1", "--print_freq", "3", "--save_ckpt_freq", "5"]
    args, _ = shard_args(tmp_path, pattern, *argv, val_pattern=val_pattern, jax_args=False)
    init = create_model(NAME, MODS2, MODS2)
    init.init_random_(torch.Generator().manual_seed(args.seed))
    trunk = [k for k, v in shared_params_mask(init).items() if v]
    snapshots, nexts = {}, {"n": 0}

    def on_epoch(epoch, model, stats):
        snapshots[epoch] = ({k: v.clone() for k, v in model.state_dict().items()}, stats)

    real_next = port_loader.LoaderIterator.__next__

    def counting_next(self):
        nexts["n"] += 1
        return real_next(self)

    monkeypatch.setattr(port_loader.LoaderIterator, "__next__", counting_next)
    run_training.main(args, on_epoch=on_epoch)
    records = [json.loads(line) for line in (out / "log.txt").read_text().splitlines()]
    evals = [r for r in records if "val_set_loss" in r]
    assert [r["epoch"] for r in evals] == [0, 1]
    for r in evals:
        assert set(r) == {"epoch"} | {f"{p}_set_{k}" for p in ("val", "fixed_eval")
                                      for k in ("loss", "loss_tok_cam", "loss_tok_rgb")}
        assert all(np.isfinite(v) for v in r.values())
    assert snapshots[0][1] == {k: v for k, v in evals[0].items() if k != "epoch"}
    state0, state1 = snapshots[0][0], snapshots[1][0]
    for k in trunk:
        assert torch.equal(state0[k], init.state_dict()[k]), k
    assert sum(not torch.equal(state1[k], state0[k]) for k in trunk) > len(trunk) // 2
    assert not torch.equal(state0["mask_token"], init.mask_token.detach())
    assert nexts["n"] == 6 + 2 * 4  # 6 train batches, 2 val + 2 fixed-eval an epoch
    nexts["n"] = 0
    args.epochs = 3
    run_training.main(args)
    assert nexts["n"] == 3 + 4  # 3 train batches, no replay of the 6 trained on
    ckpt = torch.load(out / "checkpoint-final.pth", weights_only=False)
    assert ckpt["step"] == 9 and ckpt["epoch"] == 2


def test_trainer_refuses_what_is_not_ported(trees, tmp_path):
    """Tensor parallelism raises before anything runs; a text tokenizer
    path that names no file raises as it is read."""
    pattern, _, _, _ = trees
    args, _ = shard_args(tmp_path, pattern, "--tensor_parallel", "2")
    with pytest.raises(NotImplementedError, match="tensor"):
        run_training.main(args)
    args, _ = shard_args(tmp_path, pattern, "--text_tokenizer_path", str(tmp_path / "tok.json"))
    with pytest.raises(FileNotFoundError):
        run_training.setup_data(args)
