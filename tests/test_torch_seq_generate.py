"""Caption generation and caption-conditioned generation in the port
against the JAX package, on the small model of test_torch_seq_model.py
(float32 compute, dense attention):

* rgb2caption with CFG 2.0: the autoregressive decoder's logits, teacher
  forced on the same output slots, within LOGITS_ATOL for every slot; the
  port's greedy caption equals the argmax of the JAX logits wherever the
  top-1 / top-2 gap is clear, and fills a contiguous prefix;
* caption2rgb with CFG 2.0 on the caption (the stacked 2B-row step): the
  candidate logits within the same bound, the same positions filled, and
  the greedy tokens the argmax of JAX's;
* the span merge through a tokenizer, generate_iter, and conditioning
  tensors already on the device.

Sampled tokens are never compared: jax.random and torch.Generator draw
different numbers.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egom2p_tpu.generate.sampler as jsampler
from egom2p_torch.compat.from_jax import egom2p_state_dict_from_jax
from egom2p_torch.data.span import get_sentinel_to_id_mapping, merge_span_masking
from egom2p_torch.generate import sampler as tsampler
from egom2p_torch.generate import schedules as tsched
from egom2p_torch.models.egom2p import create_model
from egom2p_torch.ops.attention import inference_attention
from egom2p_tpu.models.egom2p import EgoM2P as JaxEgoM2P
from egom2p_tpu.models.egom2p import create_model as jax_create_model

from test_torch_seq_model import NAME, SMALL, seq_info, to_jax, tok  # noqa: F401

torch.set_num_threads(2)

MODS = ("caption", "tok_rgb")
SLOTS = 12         # the empty caption target: S = 11 output slots
B = 2
# fp32 logits of the CFG-mixed (2 l_c - l_u) last rows through 2 + 2 blocks
LOGITS_ATOL = 2.5e-3
GAP = 10 * LOGITS_ATOL


@pytest.fixture
def exact_topk(monkeypatch):
    monkeypatch.setenv("EGOM2P_EXACT_TOPK", "1")


@pytest.fixture
def fresh_xla_programs():
    """Compile this test's JAX programs in this process, not from the
    persistent cache (test_torch_generate.py's fixture of the same name)."""
    from jax.experimental.compilation_cache import compilation_cache as cc
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()


@pytest.fixture(scope="module")
def models():
    info = {m: seq_info()[m] for m in MODS}
    rng = np.random.default_rng(0)
    L = info["tok_rgb"]["max_tokens"]
    md = {"tok_rgb": {"tensor": rng.integers(0, 96, (B, L)).astype(np.int32)}}
    jsampler.init_full_input_modality(md, info, "tok_rgb")
    jsampler.init_empty_target_modality(md, info, "caption", B, SLOTS)
    jmodel = jax_create_model(NAME, MODS, MODS, modality_info=info, **SMALL)
    params = jmodel.init(jax.random.PRNGKey(1), to_jax(md), 16, 16)
    tmodel = create_model(NAME, MODS, MODS, modality_info=info, **SMALL)
    tmodel.load_state_dict(egom2p_state_dict_from_jax(params, tmodel))
    return info, md, jmodel, params, tmodel.eval()


def _ar_logits(info, md, jmodel, params, tmodel, out_ids):
    """(JAX, port) CFG-mixed logits (B, S, V) of the caption's output slots,
    teacher forced on `out_ids` (B, S): each package's encoder over the
    stacked cond / uncond batch, the slots' bf16 positions, one re-forward."""
    js = jsampler.GenerationSampler(jmodel, params, info)
    stacked = js._stack_dicts(md, js._make_uncond(md, ["tok_rgb"]))
    n = jsampler._bucket(js._num_enc_tokens(stacked))
    d = stacked["caption"]
    ids_keep = np.argsort(d["target_mask"] + np.arange(SLOTS)[None] * 1e-6, axis=1)[:, :SLOTS - 1]
    outs = np.concatenate([out_ids, out_ids])
    ctx, mask = jmodel.apply(params, to_jax(stacked), n, method=JaxEgoM2P.forward_enc_context)
    emb = jmodel.apply(params, to_jax(stacked)["caption"], method=lambda m, dd: (
        m.decoder_embeddings["caption"].forward_embed(dd, m._dec_mod_emb["caption"])[1]))
    y_emb = jnp.take_along_axis(emb, jnp.asarray(ids_keep)[..., None], axis=1)
    jl = np.asarray(jmodel.apply(params, "caption", jnp.asarray(outs), y_emb, ctx, mask,
                                 method=JaxEgoM2P.forward_dec_autoregressive_logits))
    with torch.no_grad(), inference_attention():
        tdev = {m: {k: torch.from_numpy(np.asarray(v)) for k, v in dd.items()}
                for m, dd in stacked.items()}
        tctx, tmask = tmodel.forward_enc_context(tdev, n)
        _, temb, _ = tmodel.decoder_embeddings["caption"].forward_embed(tdev["caption"],
                                                                        torch.bfloat16)
        ty = torch.gather(temb, 1, torch.from_numpy(ids_keep)[..., None].expand(-1, -1, 192))
        tl = tmodel.forward_dec_autoregressive_logits("caption", torch.from_numpy(outs), ty,
                                                      tctx, tmask).numpy()
    mix = lambda x: x[B:] + (x[:B] - x[B:]) * 2.0  # noqa: E731
    return mix(jl), mix(tl)


def _schedule(cond, target, scheme, steps, cfg, temp=0.0, tokens=SLOTS):
    return tsched.build_chained_generation_schedules(
        [cond], [target], [tokens], [scheme], [steps], ["linear"], [temp], ["constant"],
        [cfg], ["constant"])


def test_rgb2caption_logits_and_greedy_tokens_match_jax(models, exact_topk, fresh_xla_programs):
    info, md, jmodel, params, tmodel = models
    ts = tsampler.GenerationSampler(tmodel, info)
    out = ts.generate(copy.deepcopy(md), _schedule("tok_rgb", "caption", "autoregressive", 0, 2.0),
                      seed=3)["caption"]
    filled = ~out["input_mask"]
    n_gen = int(filled[0].sum()) - 1  # slot 0 held the given [S_1]
    assert n_gen >= 3 and (filled.sum(1) == filled[0].sum()).all()
    idx = np.where(filled[0])[0]
    np.testing.assert_array_equal(idx, np.arange(len(idx)))  # a prefix, left to right
    tokens = out["tensor"][:, 1:SLOTS]  # the S output slots, the first given
    assert (tokens[:, :n_gen] < info["caption"]["vocab_size"]).all()

    jl, tl = _ar_logits(info, md, jmodel, params, tmodel, tokens)
    np.testing.assert_allclose(tl, jl, atol=LOGITS_ATOL, rtol=0)
    rows = jl[:, :n_gen - 1]  # row i - 1's logits choose slot i
    top2 = np.sort(rows, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > GAP
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(tokens[:, 1:n_gen][clear], rows.argmax(-1)[clear])


def test_ar_step_counts_and_stops_at_the_final_sentinel(models, monkeypatch):
    """The loop re-runs the decoder once per slot after the first and stops
    when every row holds the final sentinel."""
    info, md, _, _, tmodel = models
    ts = tsampler.GenerationSampler(tmodel, info)
    calls = {"n": 0}
    real = tmodel.forward_dec_autoregressive_hidden

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tmodel, "forward_dec_autoregressive_hidden", counted)
    final = int(md["caption"]["tensor"][0, -1])
    real_sample = tsampler.sample_tokens
    monkeypatch.setattr(tsampler, "sample_tokens", lambda logits, *a: (
        torch.full(logits.shape[:1], final, dtype=torch.int32) if calls["n"] >= 4
        else real_sample(logits, *a)[0], None))
    n = ts._seq_step(copy.deepcopy(md), "caption", 0.0, 0.0, 0.0, ["tok_rgb"], 2.0,
                     torch.Generator().manual_seed(0))
    assert calls["n"] == 4 and n == 5


def test_caption2rgb_stacked_cfg_step_matches_jax(models, exact_topk, tok,  # noqa: F811
                                                 fresh_xla_programs):
    info, _, jmodel, params, tmodel = models
    rng = np.random.default_rng(4)
    L = info["tok_rgb"]["max_tokens"]
    caption = np.zeros((B, 2 * SLOTS + 2), np.int32)
    for b in range(B):
        ids = tok.encode("a man walks the dog in the park").ids[:6 + b]
        caption[b, :len(ids)] = ids
        caption[b, len(ids)] = tok.token_to_id("[EOS]")
    md = {"caption": {"tensor": caption}, "tok_rgb": {}}
    jsampler.init_full_input_modality(md, info, "caption", eos_id=tok.token_to_id("[EOS]"))
    jsampler.init_empty_target_modality(md, info, "tok_rgb", B, L)
    md["tok_rgb"]["tensor"][:] = rng.integers(0, 96, (B, L))
    schedule = _schedule("caption", "tok_rgb", "roar", 2, 2.0, tokens=L)
    js = jsampler.GenerationSampler(jmodel, params, info)
    ts = tsampler.GenerationSampler(tmodel, info)
    state = copy.deepcopy(md)
    for step, s in enumerate(schedule):
        jout = js.generate(copy.deepcopy(state), [s], seed=5 + step)
        tout = ts.generate(copy.deepcopy(state), [s], seed=5 + step)
        for key in ("input_mask", "target_mask"):
            np.testing.assert_array_equal(tout["tok_rgb"][key], jout["tok_rgb"][key])
        ids_keep = js._select_positions(state["tok_rgb"]["target_mask"], s["num_tokens"],
                                        np.random.default_rng(5 + step), True)
        stacked = js._stack_dicts(state, js._make_uncond(state, ["caption"]))
        n = jsampler._bucket(js._num_enc_tokens(stacked))
        two = np.concatenate([ids_keep, ids_keep])
        ctx, mask = jmodel.apply(params, to_jax(stacked), n, method=JaxEgoM2P.forward_enc_context)
        y = jmodel.apply(params, to_jax(stacked), "tok_rgb", ctx, mask, jnp.asarray(two),
                         method=JaxEgoM2P.forward_dec_subset_hidden)
        y = y[B:] + 2.0 * (y[:B] - y[B:])
        jl = np.asarray(jmodel.apply(params, "tok_rgb", y, method=JaxEgoM2P.forward_mod_logits))
        with torch.no_grad(), inference_attention():
            tdev = ts._to_device(stacked)
            tctx, tmask = tmodel.forward_enc_context(tdev, n)
            ty = tmodel.forward_dec_subset_hidden(tdev, "tok_rgb", tctx, tmask,
                                                  torch.from_numpy(two).long())
            tl = tmodel.forward_mod_logits("tok_rgb", ty[B:] + 2.0 * (ty[:B] - ty[B:])).numpy()
        np.testing.assert_allclose(tl, jl, atol=LOGITS_ATOL, rtol=0)
        top2 = np.sort(jl, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > GAP
        rows = np.arange(B)[:, None]
        np.testing.assert_array_equal(tout["tok_rgb"]["tensor"][rows, ids_keep][clear],
                                      jl.argmax(-1)[clear])
        state = jout
    assert not tout["tok_rgb"]["input_mask"].any()


def test_caption_merged_through_the_tokenizer(models, tok):  # noqa: F811
    """With a text tokenizer the predicted spans replace the input's
    sentinels: the merge of the raw run's tokens, by JAX's rule."""
    info, md, _, _, tmodel = models
    ts = tsampler.GenerationSampler(tmodel, info)
    schedule = _schedule("tok_rgb", "caption", "autoregressive", 0, 1.0)
    raw = ts.generate(copy.deepcopy(md), schedule, seed=1)["caption"]
    merged = ts.generate(copy.deepcopy(md), schedule, seed=1, text_tokenizer=tok)["caption"]
    sentinels = set(get_sentinel_to_id_mapping(tok).values())
    for b in range(B):
        inp = md["caption"]["tensor"][b][~md["caption"]["input_mask"][b]].tolist()
        n = int((~raw["input_mask"][b]).sum()) - 1
        want = jsampler_merge(inp, raw["tensor"][b, 1:1 + n].tolist(), sentinels)
        assert want == merge_span_masking(inp, raw["tensor"][b, 1:1 + n].tolist(), sentinels)
        got = merged["tensor"][b][~merged["input_mask"][b]].tolist()
        assert got == want
    assert merged["target_mask"].all() and not merged["decoder_attention_mask"].any()


def jsampler_merge(inp, out, sentinels):
    from egom2p_tpu.masking.span import merge_span_masking as jmerge
    return jmerge(inp, out, sentinels)


def test_generate_iter_and_device_conditioning(models):
    """generate_iter gives generate's result step by step; a conditioning
    tensor already on the device goes through the host-side caption step."""
    info, md, _, _, tmodel = models
    ts = tsampler.GenerationSampler(tmodel, info)
    schedule = _schedule("tok_rgb", "caption", "autoregressive", 0, 2.0)
    whole = ts.generate(copy.deepcopy(md), schedule, seed=7)
    steps = list(ts.generate_iter(copy.deepcopy(md), schedule, seed=7))
    assert len(steps) == len(schedule)
    for k in whole["caption"]:
        np.testing.assert_array_equal(steps[-1]["caption"][k], whole["caption"][k])
    on_dev = copy.deepcopy(md)
    on_dev["tok_rgb"]["tensor"] = torch.from_numpy(on_dev["tok_rgb"]["tensor"])
    again = ts.generate(on_dev, schedule, seed=7)
    np.testing.assert_array_equal(again["caption"]["tensor"], whole["caption"]["tensor"])
