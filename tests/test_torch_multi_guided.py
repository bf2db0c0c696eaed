"""Multi-condition guidance, dense sequence generation, the raw-pixel patch
embedding and EgoM2P-large's true width on the port against the JAX
package, on the CPU (float32 compute, dense attention; EGOM2P_EXACT_TOPK=1
and EGOM2P_CFG_MIX=logits, ROADMAP Queue 3's list):

* generate_multi_guided: conditions {tok_rgb} and {tok_cam} at weights
  [2.0, 1.0] over tok_depth (2 ROAR steps), then tok_gaze (1 step) with
  the finished tok_depth joining as a third condition.  At every step the
  port's stacked [cond_1, ..., cond_n, uncond] batch gives mixed logits
  l_u + sum_i w_i (l_c_i - l_u) within LOGITS_ATOL of JAX's on the same
  batch, and its greedy tokens are JAX's argmax wherever the top-2 gap is
  clear; the positions filled equal JAX's own run.
* generate_sam_dense on a tokenizer.json the test writes: the expansion,
  the schedule's filter and the concatenated span merge bitwise JAX's on
  the same generated rows, and a run of the port's own generation.
* ImagePatchEncoderEmbedding and an encoder context with an rgb@224 input.
* One encoder and one decoder block at EgoM2P-large's width (dim 1020, 15
  heads of 68) carried from JAX random-init weights: the loss and the
  encoder context (the check left from the third slice, tested before at
  dim 204 only).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egom2p_tpu.generate.sampler as jsampler
from egom2p_torch.compat.from_jax import egom2p_state_dict_from_jax
from egom2p_torch.generate import sampler as tsampler
from egom2p_torch.models.egom2p import create_model
from egom2p_tpu.data.modality_info import MODALITY_INFO as JAX_INFO
from egom2p_tpu.models.egom2p import EgoM2P as JaxEgoM2P
from egom2p_tpu.models.egom2p import create_model as jax_create_model
from tests.test_torch_model import MODS4, tiny_info

torch.set_num_threads(2)

NAME = "egom2p_tiny_6e_6d_swiglu_nobias"
DEPTHS = dict(encoder_depth=2, decoder_depth=2, compute_dtype="float32")
B = 2
LOGITS_ATOL = 2.5e-3   # fp32 mixed logits through 2 + 2 blocks (test_torch_seq_generate.py's)
GAP = 10 * LOGITS_ATOL
WEIGHTS = [2.0, 1.0]


def to_jax(md):
    return {m: {k: jnp.asarray(v) for k, v in d.items()} for m, d in md.items()}


@pytest.fixture
def parity_env(monkeypatch):
    monkeypatch.setenv("EGOM2P_EXACT_TOPK", "1")
    monkeypatch.setenv("EGOM2P_CFG_MIX", "logits")


@pytest.fixture(scope="module")
def models():
    info = tiny_info()
    rng = np.random.default_rng(0)
    md = {}
    for m in ("tok_rgb", "tok_cam"):
        md[m] = {"tensor": rng.integers(0, info[m]["vocab_size"],
                                        (B, info[m]["max_tokens"])).astype(np.int32)}
        jsampler.init_full_input_modality(md, info, m)
    for m in ("tok_depth", "tok_gaze"):
        jsampler.init_empty_target_modality(md, info, m, B, info[m]["max_tokens"])
    jmodel = jax_create_model(NAME, MODS4, MODS4, modality_info=info, **DEPTHS)
    params = jmodel.init(jax.random.PRNGKey(1), to_jax(md), 128, 64)
    tmodel = create_model(NAME, MODS4, MODS4, modality_info=info, **DEPTHS)
    tmodel.load_state_dict(egom2p_state_dict_from_jax(params, tmodel))
    return info, md, jmodel, params, tmodel.eval()


def _multi_inputs(md):
    """(uncond, conds): every modality with the conditioning ones emptied;
    {tok_rgb} and {tok_cam} fully visible."""
    uncond = copy.deepcopy(md)
    for m in ("tok_rgb", "tok_cam"):
        jsampler.empty_img_modality(uncond[m])
    return uncond, [{"tok_rgb": copy.deepcopy(md["tok_rgb"])},
                    {"tok_cam": copy.deepcopy(md["tok_cam"])}]


def _schedule(info):
    s = dict(scheme="roar", temperature=0.0, cfg_scale=WEIGHTS)
    return [dict(s, target_domain="tok_depth", num_tokens=16),
            dict(s, target_domain="tok_depth", num_tokens=16),
            dict(s, target_domain="tok_gaze", num_tokens=info["tok_gaze"]["max_tokens"])]


def test_multi_guided_matches_jax(models, parity_env, monkeypatch):
    info, md, jmodel, params, tmodel = models
    uncond, conds = _multi_inputs(md)
    schedule = _schedule(info)
    js = jsampler.GenerationSampler(jmodel, params, info)
    j_out = js.generate_multi_guided(copy.deepcopy(uncond), copy.deepcopy(conds), schedule,
                                     seed=4)
    ts = tsampler.GenerationSampler(tmodel, info)
    seen = []
    real_head = tsampler.chunked_head_sample

    def spy(model, target_mod, y, weights, *a):
        samples, probs = real_head(model, target_mod, y, weights, *a)
        seen.append({"target": target_mod, "weights": weights, "samples": samples.numpy()})
        return samples, probs

    real_dev = ts._to_device
    monkeypatch.setattr(tsampler, "chunked_head_sample", spy)
    monkeypatch.setattr(ts, "_to_device",
                        lambda d: seen.append({"stacked": copy.deepcopy(d)}) or real_dev(d))
    real_dec = tmodel.forward_dec_subset_hidden
    monkeypatch.setattr(tmodel, "forward_dec_subset_hidden",
                        lambda *a: seen.append({"ids": a[-1].numpy()}) or real_dec(*a))
    t_out = ts.generate_multi_guided(copy.deepcopy(uncond), copy.deepcopy(conds), schedule,
                                     seed=4)
    for m in ("tok_depth", "tok_gaze"):
        for k in ("input_mask", "target_mask"):
            np.testing.assert_array_equal(t_out[m][k], j_out[m][k], err_msg=f"{m} {k}")
        assert t_out[m]["target_mask"].all()
    steps = [dict(a, **b, **c) for a, b, c in zip(seen[0::3], seen[1::3], seen[2::3])]
    assert [len(s["weights"]) for s in steps] == [2, 2, 3]  # tok_depth joined
    assert list(steps[2]["weights"]) == [2.0, 1.0, 1.0]
    for s in steps:
        stacked, ids, w = s["stacked"], s["ids"], s["weights"]
        G = len(w) + 1
        n = jsampler._bucket(js._num_enc_tokens(stacked))
        ctx, mask = jmodel.apply(params, to_jax(stacked), n, method=JaxEgoM2P.forward_enc_context)
        y = jmodel.apply(params, to_jax(stacked), s["target"], ctx, mask, jnp.asarray(ids),
                         method=JaxEgoM2P.forward_dec_subset_hidden)
        jl = np.asarray(jmodel.apply(params, s["target"], y, method=JaxEgoM2P.forward_mod_logits))
        with torch.no_grad():
            tdev = {m: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
                    for m, d in stacked.items()}
            tctx, tmask = tmodel.forward_enc_context(tdev, n)
            ty = real_dec(tdev, s["target"], tctx, tmask, torch.from_numpy(ids))
            tl = tmodel.forward_mod_logits(s["target"], ty).numpy()
        mix = lambda lg: lg[(G - 1) * B:] + sum(  # noqa: E731
            wi * (lg[i * B:(i + 1) * B] - lg[(G - 1) * B:]) for i, wi in enumerate(w))
        jm = mix(jl)
        np.testing.assert_allclose(mix(tl), jm, atol=LOGITS_ATOL, rtol=0)
        top2 = np.sort(jm, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > GAP
        assert clear.mean() > 0.5
        np.testing.assert_array_equal(s["samples"][clear], jm.argmax(-1)[clear])


def test_multi_guided_pads_missing_modalities_from_uncond(models):
    """A condition without tok_cam gets uncond's, fully masked: its
    encoder input is the {tok_rgb} rows only."""
    info, md, _, _, tmodel = models
    uncond, conds = _multi_inputs(md)
    ts = tsampler.GenerationSampler(tmodel, info)
    stacked = []
    real = ts._to_device
    ts._to_device = lambda d: stacked.append(d) or real(d)
    ts.generate_multi_guided(uncond, conds, _schedule(info)[:1], seed=0)
    cam_mask = stacked[0]["tok_cam"]["input_mask"]
    assert cam_mask[:B].all() and not cam_mask[B:2 * B].any() and cam_mask[2 * B:].all()


@pytest.fixture(scope="module")
def seq_models(tmp_path_factory):
    from test_torch_seq_model import NAME as SEQ_NAME, SMALL, seq_info
    from egom2p_torch.utils.text_tokenizer import load_text_tokenizer, write_wordpiece_json
    from tests.test_torch_text import WORDS

    tok = load_text_tokenizer(write_wordpiece_json(
        str(tmp_path_factory.mktemp("tok") / "tokenizer.json"), WORDS, num_sentinels=16))
    mods = ("caption", "tok_rgb")
    info = {m: seq_info()[m] for m in mods}
    rng = np.random.default_rng(0)
    md = {"tok_rgb": {"tensor": rng.integers(0, 96, (1, info["tok_rgb"]["max_tokens"]))
                      .astype(np.int32)}}
    jsampler.init_full_input_modality(md, info, "tok_rgb")
    jsampler.init_empty_target_modality(md, info, "caption", 1, 12)
    jmodel = jax_create_model(SEQ_NAME, mods, mods, modality_info=info, **SMALL)
    params = jmodel.init(jax.random.PRNGKey(1), to_jax(md), 16, 16)
    tmodel = create_model(SEQ_NAME, mods, mods, modality_info=info, **SMALL)
    tmodel.load_state_dict(egom2p_state_dict_from_jax(params, tmodel))
    return info, md, jmodel, params, tmodel.eval(), tok


def test_sam_dense_merge_matches_jax(seq_models, monkeypatch):
    """Both packages' generate_sam_dense on the same generated rows (JAX's
    generation, handed to the port's): the merged sequence bitwise; then
    the port's own generation end to end."""
    info, md, jmodel, params, tmodel, tok = seq_models
    s = dict(scheme="autoregressive", num_tokens=12, temperature=0.0, cfg_scale=1.0)
    schedule = [dict(s, target_domain="tok_rgb"), dict(s, target_domain="caption")]
    js = jsampler.GenerationSampler(jmodel, params, info)
    generated = []
    real_generate = js.generate
    monkeypatch.setattr(js, "generate", lambda *a, **kw: generated.append(
        (copy.deepcopy(a), real_generate(*a, **kw))) or generated[-1][1])
    j_out = js.generate_sam_dense(copy.deepcopy(md), schedule, tok, batch_size=3, key="caption",
                                  seed=2)
    (j_args, j_rows), = generated
    ts = tsampler.GenerationSampler(tmodel, info)
    calls = []

    def fake(mod_dict, sched, **kw):
        calls.append((mod_dict, sched))
        return copy.deepcopy(j_rows)
    monkeypatch.setattr(ts, "generate", fake)
    t_out = ts.generate_sam_dense(copy.deepcopy(md), schedule, tok, batch_size=3, key="caption",
                                  seed=2)
    (t_md, t_sched), = calls
    assert [x["target_domain"] for x in t_sched] == ["caption"]
    for m in md:
        for k in md[m]:
            np.testing.assert_array_equal(t_md[m][k], j_args[0][m][k])
    for k in ("tensor", "input_mask", "target_mask", "decoder_attention_mask"):
        np.testing.assert_array_equal(t_out["caption"][k], j_out["caption"][k])
        assert t_out["caption"][k].dtype == j_out["caption"][k].dtype
    np.testing.assert_array_equal(t_out["tok_rgb"]["tensor"], md["tok_rgb"]["tensor"])
    monkeypatch.undo()
    own = tsampler.GenerationSampler(tmodel, info).generate_sam_dense(
        copy.deepcopy(md), schedule, tok, batch_size=3, key="caption", seed=2)
    seq = own["caption"]["tensor"]
    assert seq.shape[0] == 1 and seq.shape[1] >= 3 and (seq < info["caption"]["vocab_size"]).all()


def test_image_patch_embedding_and_rgb224_context_match_jax():
    """rgb@224 pixels through the bias-free patch projection ((ph, pw, C)
    order), the 2-D sincos posemb and the modality embedding, then an
    encoder context over rgb@224 + tok_depth, against JAX's."""
    info = tiny_info()
    info["rgb@224"] = copy.deepcopy(JAX_INFO["rgb@224"])
    mods_in, mods_out = ("rgb@224", "tok_depth"), ("tok_depth",)
    rng = np.random.default_rng(3)
    md = {"rgb@224": {"tensor": rng.uniform(-1, 1, (B, 224, 224, 3)).astype(np.float32),
                      "input_mask": rng.uniform(size=(B, 196)) > 0.7,
                      "target_mask": np.ones((B, 196), bool)},
          "tok_depth": {"tensor": rng.integers(0, 96, (B, 32)).astype(np.int32),
                        "input_mask": rng.uniform(size=(B, 32)) > 0.5,
                        "target_mask": rng.uniform(size=(B, 32)) > 0.5,
                        "decoder_attention_mask": np.zeros((B, 32), np.int32)}}
    jmodel = jax_create_model(NAME, mods_in, mods_out, modality_info=info, **DEPTHS)
    params = jmodel.init(jax.random.PRNGKey(2), to_jax(md), 128, 32)
    tmodel = create_model(NAME, mods_in, mods_out, modality_info=info, **DEPTHS)
    sd = egom2p_state_dict_from_jax(params, tmodel)
    assert tuple(sd["encoder_embeddings.rgb@224.proj.weight"].shape) == (384, 16 * 16 * 3)
    tmodel.load_state_dict(sd)
    tmd = {m: {k: torch.from_numpy(v) for k, v in d.items()} for m, d in md.items()}
    j_x, j_emb = jmodel.apply(params, to_jax(md)["rgb@224"], method=lambda m, d: (
        m.encoder_embeddings["rgb@224"](d, m._mod_emb["rgb@224"], jnp.float32)))
    with torch.no_grad():
        t_x, t_emb = tmodel.encoder_embeddings["rgb@224"](tmd["rgb@224"], torch.float32)
    np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), atol=1e-6, rtol=0)
    j_ctx, j_mask = jmodel.apply(params, to_jax(md), 128, method=JaxEgoM2P.forward_enc_context)
    with torch.no_grad():
        t_ctx, t_mask = tmodel.forward_enc_context(tmd, 128)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(t_ctx.numpy(), np.asarray(j_ctx), atol=2e-4, rtol=0)


def test_large_width_layer_from_jax():
    """EgoM2P-large's true width, 1 + 1 blocks (dim 1020, 15 heads of 68):
    JAX random-init weights through egom2p_state_dict_from_jax, the loss
    and the encoder context on the dense path against JAX's."""
    from tests.test_torch_model import make_mod_dict

    info = tiny_info()
    large = dict(encoder_depth=1, decoder_depth=1, compute_dtype="float32")
    name = "egom2p_large_24e_24d_swiglu_nobias"
    md = make_mod_dict(np.random.default_rng(5), info)
    jmodel = jax_create_model(name, MODS4, MODS4, modality_info=info, **large)
    params = jmodel.init(jax.random.PRNGKey(6), to_jax(md), 64, 64)
    tmodel = create_model(name, MODS4, MODS4, modality_info=info, **large)
    assert tmodel.config.dim == 1020 and tmodel.config.num_heads == 15
    tmodel.load_state_dict(egom2p_state_dict_from_jax(params, tmodel))
    tmd = {m: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for m, d in md.items()}
    j_loss, _ = jmodel.apply(params, to_jax(md), 64, 64, "mod")
    with torch.no_grad():
        t_loss, _ = tmodel(tmd, 64, 64, "mod")
        t_ctx, _ = tmodel.forward_enc_context(tmd, 64)
    j_ctx, _ = jmodel.apply(params, to_jax(md), 64, method=JaxEgoM2P.forward_enc_context)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(t_ctx.numpy(), np.asarray(j_ctx), atol=1e-4, rtol=0)
