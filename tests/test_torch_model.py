"""EgoM2P inference forward in the PyTorch port against the JAX package.

Same weights (JAX random init moved over by compat/from_jax.py) and the same
numpy inputs go through both at compute_dtype float32.  Attention routes as
in generation: inside `inference_attention()` eligible calls take flash64
(the port: its plain version on the CPU; JAX: the Pallas kernel in interpret
mode), the rest the dense path.
"""
import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egom2p_tpu.ops.flash64 as jax_f64
import egom2p_tpu.ops.flash_attention as jax_fa
from egom2p_torch.compat.from_jax import egom2p_state_dict_from_jax
from egom2p_torch.models import transformer as tt
from egom2p_torch.models.egom2p import create_model
from egom2p_torch.ops.attention import inference_attention
from egom2p_tpu.data.modality_info import MODALITY_INFO as JAX_INFO
from egom2p_tpu.models import transformer as jt
from egom2p_tpu.models.egom2p import EgoM2P as JaxEgoM2P
from egom2p_tpu.models.egom2p import create_model as jax_create_model
from egom2p_tpu.ops.attention import inference_attention as jax_inference_attention

torch.set_num_threads(2)

MODS4 = ("tok_cam", "tok_depth", "tok_gaze", "tok_rgb")
NAME = "egom2p_tiny_6e_6d_swiglu_nobias"
# LayerNorm-scale hidden states at float32.  On the dense path the two
# packages agree to ~4e-6; every flash64 call rounds q/k/v, p and its output
# to bf16, and fp32 differences in the order of sums flip some of those
# roundings.  A flipped rounding of an O(1) value is one bf16 ulp, 2^-8 to
# 2^-7 (3.9e-3 to 7.8e-3): which elements flip depends on the machine's sum
# order, so one maximum measured on one machine is no limit.  The checks are
# therefore two (`assert_hidden_close`): the bulk, where no flip survives
# (mean |err| <= BULK_MEAN_ATOL and all but BULK_OUTLIERS of the elements
# within the bulk tolerance; measured mean 3e-4 to 9e-4, a handful of
# elements in 4e5 beyond 5e-3), and a hard maximum of two ulps of the
# largest O(1) value, which a genuine fault (a wrong mask, a missed scale)
# exceeds at once.
HIDDEN_ATOL = 5e-3          # bulk, up to 12 flash64 attentions in depth
HIDDEN_MAX_ATOL = 1.6e-2    # two bf16 ulps at 2^-7
# through all 18 of the tiny model's generation path (6 encoder, 6 decoder
# self, 6 cross) more roundings flip and each is amplified downstream
DEEP_HIDDEN_ATOL = 1e-2
DEEP_HIDDEN_MAX_ATOL = 2e-2
BULK_MEAN_ATOL = 1.5e-3
BULK_OUTLIERS = 1e-4        # share of elements allowed beyond the bulk tolerance


def assert_hidden_close(got, ref, name, bulk_atol=HIDDEN_ATOL, max_atol=HIDDEN_MAX_ATOL):
    assert got.shape == ref.shape, name
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.isfinite(err).all(), name
    outliers = float((err > bulk_atol).mean())
    assert err.mean() <= BULK_MEAN_ATOL, f"{name}: mean |err| {err.mean():.3e}"
    assert outliers <= BULK_OUTLIERS, (
        f"{name}: {outliers:.2e} of the elements beyond {bulk_atol}")
    assert err.max() <= max_atol, f"{name}: max |err| {err.max():.3e} > {max_atol}"


def tiny_info(video_grid=(2, 4, 4)):
    """tests/test_model.py's tiny registry (vocab 96 video grids, length-8
    vocab-32 cam/gaze); a larger `video_grid` puts encoder lengths on the
    flash64 path (N * M >= 256^2)."""
    info = copy.deepcopy({m: JAX_INFO[m] for m in MODS4})
    n = int(np.prod(video_grid))
    for m in ("tok_rgb", "tok_depth"):
        info[m].update(vocab_size=96, max_tokens=n)
        info[m]["embed_spec"] = {"kind": "video_token", "vocab_size": 96,
                                 "grid": tuple(video_grid)}
    for m in ("tok_cam", "tok_gaze"):
        info[m].update(vocab_size=32, max_tokens=8)
        info[m]["embed_spec"] = {"kind": "gazecam_token", "vocab_size": 32, "length": 8}
    return info


def make_mod_dict(rng, info, batch=2, visible=0.5):
    """Random tokens with a random visible subset per row (host numpy)."""
    out = {}
    for m in MODS4:
        L, V = info[m]["max_tokens"], info[m]["vocab_size"]
        out[m] = {"tensor": rng.integers(0, V, (batch, L)).astype(np.int32),
                  "input_mask": rng.uniform(size=(batch, L)) > visible,
                  "target_mask": rng.uniform(size=(batch, L)) > 0.5,
                  "decoder_attention_mask": np.zeros((batch, L), np.int32)}
    return out


def to_jax(md):
    return {m: {k: jnp.asarray(v) for k, v in d.items()} for m, d in md.items()}


def to_torch(md):
    return {m: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
            for m, d in md.items()}


@pytest.fixture
def jax_flash(monkeypatch):
    """The JAX package's generation routing on the CPU: flash64 through the
    real Pallas kernel in interpret mode (tests/test_flash64_train.py's
    recipe).  Counts the calls."""
    calls = {"n": 0}
    real = jax_f64.flash64_attention

    def interpret(*a, **kw):
        calls["n"] += 1
        return real(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(jax_f64, "flash64_attention", interpret)
    monkeypatch.setattr(jax_fa, "supports_flash", lambda: True)
    return calls


def _models(info, seed=0):
    jmodel = jax_create_model(NAME, MODS4, MODS4, modality_info=info,
                              compute_dtype="float32")
    md = make_mod_dict(np.random.default_rng(seed), info)
    n = info["tok_rgb"]["max_tokens"]
    # init runs the training forward: keep it off the (CPU-less) kernels
    with mock.patch.object(jax_fa, "supports_flash", lambda: False):
        params = jmodel.init(jax.random.PRNGKey(seed), to_jax(md), n, n)
    tmodel = create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32")
    tmodel.load_state_dict(egom2p_state_dict_from_jax(params, tmodel))
    return jmodel, params, tmodel.eval()


@pytest.fixture(scope="module")
def flash_models():
    return _models(tiny_info((2, 8, 16)))   # 256 tokens per video modality


@pytest.fixture(scope="module")
def dense_models():
    return _models(tiny_info())              # 32 tokens: dense attention only


def test_state_dict_from_jax_is_complete(dense_models):
    jmodel, params, tmodel = dense_models
    sd = egom2p_state_dict_from_jax(params, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    # the shared modality embedding lands on both sides
    assert torch.equal(sd["encoder_embeddings.tok_rgb.mod_emb"],
                       sd["decoder_embeddings.tok_rgb.mod_emb"])
    assert tmodel.decoder_embeddings["tok_rgb"].mod_emb is \
        tmodel.encoder_embeddings["tok_rgb"].mod_emb
    extra = {"params": {**params["params"], "bogus": np.zeros(3)}}
    with pytest.raises(KeyError):
        egom2p_state_dict_from_jax(extra, tmodel)
    broken = copy.deepcopy(jax.tree_util.tree_map(np.asarray, params))
    broken["params"]["mask_token"] = np.zeros((1, 1, 7), np.float32)
    with pytest.raises(ValueError):
        egom2p_state_dict_from_jax(broken, tmodel)


def _module_sd(flax_params):
    """Flax params of one transformer module -> torch state dict (Dense
    kernels transposed; names already match)."""
    flat = jax.tree_util.tree_flatten_with_path(flax_params["params"])[0]
    sd = {}
    for path, leaf in flat:
        names = [p.key for p in path]
        arr = np.asarray(leaf, np.float32)
        if names[-1] == "kernel":
            sd[".".join(names[:-1] + ["weight"])] = torch.from_numpy(arr.T.copy())
        else:
            sd[".".join(names)] = torch.from_numpy(arr.copy())
    return sd


@pytest.mark.parametrize("n", [256, 40])      # flash64 route, dense route
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_module_matches_jax(jax_flash, n, qk_norm):
    rng = np.random.default_rng(3)
    B, H = 2, 2
    x = rng.standard_normal((B, n, H * 64)).astype(np.float32)
    mask = rng.uniform(size=(B, 1, n)) > 0.7
    mask[1] = True  # an all-blocked batch row: exact zeros through attention
    jmod = jt.Attention(num_heads=H, qk_norm=qk_norm)
    with jax_inference_attention():
        jparams = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask))
        ref = np.asarray(jmod.apply(jparams, jnp.asarray(x), jnp.asarray(mask)))
    tmod = tt.Attention(H * 64, H, qk_norm=qk_norm)
    tmod.load_state_dict(_module_sd(jparams))
    with inference_attention(), torch.no_grad():
        out = tmod(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert jax_flash["n"] == (2 if n == 256 else 0)  # init + apply
    assert_hidden_close(out, ref, "attention output", max_atol=HIDDEN_ATOL)  # one call deep


def test_cross_attention_and_blocks_match_jax(jax_flash):
    rng = np.random.default_rng(4)
    B, H, N, M = 2, 2, 300, 256
    kw = dict(mlp_ratio=4.0, qkv_bias=False, proj_bias=False, mlp_bias=False,
              norm_bias=False, gated_mlp=True)
    x = jnp.asarray(rng.standard_normal((B, N, H * 64)), jnp.float32)
    ctx = jnp.asarray(rng.standard_normal((B, M, H * 64)), jnp.float32)
    mask = jnp.asarray(rng.uniform(size=(B, 1, M)) > 0.5)
    jblock = jt.Block(num_heads=H, act=jax.nn.silu, **kw)
    jdec = jt.DecoderBlock(num_heads=H, act=jax.nn.silu, **kw)
    with jax_inference_attention():
        bp = jblock.init(jax.random.PRNGKey(2), ctx, mask)
        dp = jdec.init(jax.random.PRNGKey(3), x, ctx, None, mask)
        ref_b = np.asarray(jblock.apply(bp, ctx, mask))
        ref_d = np.asarray(jdec.apply(dp, x, ctx, None, mask))
    tkw = dict(kw, act=torch.nn.functional.silu)
    tblock, tdec = tt.Block(H * 64, H, **tkw), tt.DecoderBlock(H * 64, H, **tkw)
    tblock.load_state_dict(_module_sd(bp))
    tdec.load_state_dict(_module_sd(dp))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    with inference_attention(), torch.no_grad():
        out_b = tblock(t(ctx), t(mask)).numpy()
        out_d = tdec(t(x), t(ctx), None, t(mask)).numpy()
    assert jax_flash["n"] == 6  # (encoder self, decoder self, cross) x (init, apply)
    # one and two flash64 calls deep (measured max 2.2e-3): no flip reaches 5e-3
    assert_hidden_close(out_b, ref_b, "encoder block", max_atol=HIDDEN_ATOL)
    assert_hidden_close(out_d, ref_d, "decoder block", max_atol=HIDDEN_ATOL)


def _jax_hooks(jmodel, params, md, n_enc, ids_keep):
    with jax_inference_attention():
        ctx, mask = jmodel.apply(params, md, n_enc, method=JaxEgoM2P.forward_enc_context)
        y = jmodel.apply(params, md, "tok_depth", ctx, mask, jnp.asarray(ids_keep),
                         method=JaxEgoM2P.forward_dec_subset_hidden)
        logits = jmodel.apply(params, "tok_depth", y, method=JaxEgoM2P.forward_mod_logits)
    return [np.asarray(a) for a in (ctx, mask, y, logits)]


def _torch_hooks(tmodel, md, n_enc, ids_keep):
    with inference_attention(), torch.no_grad():
        ctx, mask = tmodel.forward_enc_context(md, n_enc)
        y = tmodel.forward_dec_subset_hidden(md, "tok_depth", ctx, mask,
                                             torch.from_numpy(ids_keep))
        logits = tmodel.forward_mod_logits("tok_depth", y)
    return [a.numpy() for a in (ctx, mask, y, logits)]


@pytest.mark.parametrize("models,n_enc,k,flash_calls,atol", [
    # every attention on flash64 (k = 300 > 256 open positions: all of them)
    ("flash_models", 256, 300, 18, DEEP_HIDDEN_ATOL),
    # encoder (N = 512 > live tokens: padding) and cross-attention on
    # flash64, decoder self-attention (200^2 < 256^2) dense
    ("flash_models", 512, 200, 12, HIDDEN_ATOL),
    ("dense_models", 48, 20, 0, HIDDEN_ATOL),
])
def test_generation_hooks_match_jax(request, jax_flash, models, n_enc, k, flash_calls, atol):
    """forward_enc_context, forward_dec_subset_hidden, forward_mod_logits."""
    jmodel, params, tmodel = request.getfixturevalue(models)
    info = tmodel.mod_info
    rng = np.random.default_rng(5)
    md = make_mod_dict(rng, info)
    L = info["tok_depth"]["max_tokens"]
    k = min(k, L)
    ids_keep = np.stack([rng.permutation(L)[:k] for _ in range(2)]).astype(np.int32)
    ref = _jax_hooks(jmodel, params, to_jax(md), n_enc, ids_keep)
    got = _torch_hooks(tmodel, to_torch(md), n_enc, ids_keep)
    assert jax_flash["n"] == flash_calls
    np.testing.assert_array_equal(got[1], ref[1])  # encoder mask / gather order
    for name, g, r in zip(("context", "decoder hidden", "logits"),
                          (got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
        if flash_calls == 0:  # dense on both sides (measured 4e-6): no rounding to flip
            assert_hidden_close(g, r, name, max_atol=HIDDEN_ATOL)
        elif name == "context" or atol == HIDDEN_ATOL:  # context: 6 flash64 deep
            assert_hidden_close(g, r, name)
        else:
            assert_hidden_close(g, r, name, DEEP_HIDDEN_ATOL, DEEP_HIDDEN_MAX_ATOL)


def test_mask_gather_matches_jax(dense_models):
    """The argsort-gather keeps unmasked tokens first, in concat order, and
    zeroes the padding slots, exactly as the JAX package."""
    jmodel, params, tmodel = dense_models
    md = make_mod_dict(np.random.default_rng(6), tmodel.mod_info, visible=0.3)

    def jprobe(m, md):
        return m.forward_mask_encoder(m.embed_encoder(md), 48)

    jt_, je, jm, jmod = jmodel.apply(params, to_jax(md), method=jprobe)
    with torch.no_grad():
        tt_, te, tm, tmod = tmodel.forward_mask_encoder(
            tmodel.embed_encoder(to_torch(md)), 48)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tmod.numpy(), np.asarray(jmod))
    np.testing.assert_allclose(tt_.numpy(), np.asarray(jt_), atol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-6)


def test_bf16_compute_dtype_runs():
    """The default compute dtype is bf16, as in JAX: activations are bf16,
    logits fp32."""
    info = tiny_info()
    model = create_model(NAME, MODS4, MODS4, modality_info=info)
    assert model.compute_dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    model.init_random_(gen).eval()
    md = to_torch(make_mod_dict(np.random.default_rng(7), info))
    with torch.no_grad():
        ctx, mask = model.forward_enc_context(md, 48)
        y = model.forward_dec_subset_hidden(md, "tok_depth", ctx, mask,
                                            torch.arange(10)[None].repeat(2, 1))
        logits = model.forward_mod_logits("tok_depth", y)
    assert ctx.dtype == y.dtype == torch.bfloat16 and logits.dtype == torch.float32
    assert torch.isfinite(logits).all() and logits.shape == (2, 10, 96)


@pytest.mark.parametrize("compute_dtype", [torch.bfloat16, torch.float32])
def test_forward_logits_matches_jax_head(compute_dtype):
    """The generation head: fp32 logits of y and the head weight rounded to
    y's dtype, as the JAX einsum with preferred_element_type=fp32.  Under
    bf16 compute the product goes to flash_ce.matmul_f32 with bf16_values
    (TF32 on the card, exact for bf16 values); under fp32 compute in full
    fp32."""
    from egom2p_torch.models import embeddings as temb
    from egom2p_tpu.models import embeddings as jemb

    rng = np.random.default_rng(11)
    V, D = 333, 96
    head = temb.TokenGridDecoderEmbedding(V, (4,), D)
    w = rng.standard_normal((V, D), np.float32) * 0.02
    with torch.no_grad():
        head.token_emb.weight.copy_(torch.from_numpy(w))
    y32 = rng.standard_normal((2, 7, D), np.float32)
    y = torch.from_numpy(y32).to(compute_dtype)
    calls = []
    real = temb.matmul_f32

    def spy(a, b, bf16_values=None):
        calls.append(bf16_values)
        return real(a, b, bf16_values=bf16_values)

    with mock.patch.object(temb, "matmul_f32", spy), torch.no_grad():
        got = head.forward_logits(y)
    assert calls == [compute_dtype == torch.bfloat16]
    jdt = jnp.bfloat16 if compute_dtype == torch.bfloat16 else jnp.float32
    jhead = jemb.TokenGridDecoderEmbedding(V, (4,), D)
    ref = jhead.apply({"params": {"token_emb": jnp.asarray(w)}},
                      jnp.asarray(y32).astype(jdt), method="forward_logits")
    assert got.dtype == torch.float32 and got.shape == (2, 7, V)
    # fp32 sums of the same products in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-6)


def test_eval_common_smoke_loaders():
    """--smoke weights come from the seeded generator: the same seed gives
    the same model; without --smoke the loaders refuse (checkpoints are not
    ported yet)."""
    import argparse

    from egom2p_torch.cli import eval_common
    args = argparse.Namespace(model=NAME, seed=3, smoke=True)
    a = eval_common.load_main_model(args, "cpu")
    b = eval_common.load_main_model(args, "cpu")
    assert not a.training and a.in_domains == MODS4
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    tok = eval_common.load_video_tokenizer(args, "cpu")
    assert tok.compute_dtype == torch.bfloat16
    assert next(tok.net.parameters()).dtype == torch.bfloat16
    with pytest.raises(NotImplementedError):
        eval_common.load_main_model(argparse.Namespace(model=NAME, seed=0, smoke=False), "cpu")
