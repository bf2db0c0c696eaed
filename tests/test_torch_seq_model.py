"""EgoM2P with a caption in and out, in the port against the JAX package.

A small model (2 + 2 blocks, dim 192 (the video grid's 3-D sincos table
needs a multiple of 6), heads of 64) over tiny image grids, a
256-token caption of 12 slots and T5-style embeddings as an input, batches
from the port's UnifiedMasking with a tokenizer the test writes.  The JAX
random init goes through compat/from_jax.py; both run at compute float32 on
the dense attention.  Loss within LOSS_ATOL, every parameter's gradient
within GRAD_TOL of its max, for the default model, decoder_sep_mask=False,
share_modality_embeddings=False, the causal registry model and a
bottleneck emb_proj; the decoder masks; a .pth round trip.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egom2p_torch.compat.from_jax import egom2p_state_dict_from_jax
from egom2p_torch.core.checkpoint import load_egom2p_pth, save_checkpoint
from egom2p_torch.data.loader import make_empty_mod_entry
from egom2p_torch.data.masking import UnifiedMasking
from egom2p_torch.models import egom2p as port_egom2p
from egom2p_torch.models.egom2p import create_model
from egom2p_torch.utils.text_tokenizer import load_text_tokenizer, write_wordpiece_json
from egom2p_tpu.data.modality_info import generate_uint15_hash
from egom2p_tpu.models.egom2p import MODEL_REGISTRY as JAX_REGISTRY
from egom2p_tpu.models.egom2p import create_model as jax_create_model

from test_torch_model import tiny_info
from test_torch_text import WORDS

torch.set_num_threads(2)

NAME = "egom2p_tiny_6e_6d_swiglu_nobias"
CAUSAL = "egom2p_base_12e_12d_swiglu_nobias_causal"
SMALL = dict(encoder_depth=2, decoder_depth=2, dim=192, num_heads=3, compute_dtype="float32")
MODS = ("caption", "tok_cam", "tok_rgb")
LOSS_ATOL = 1e-5
GRAD_TOL = 1e-2  # of each parameter's max |JAX gradient|
N_IN = N_TGT = 24
CAPTION_VOCAB = 256  # the test tokenizer's ids (its words, letters and ## pieces) lie below


def seq_info(bottleneck=False):
    info = {m: tiny_info()[m] for m in ("tok_rgb", "tok_cam")}
    info["caption"] = {"vocab_size": CAPTION_VOCAB, "min_tokens": 0, "max_tokens": 12,
                       "type": "seq", "id": generate_uint15_hash("caption"),
                       "embed_spec": {"kind": "sequence", "vocab_size": CAPTION_VOCAB,
                                      "max_length": 12, "padding_idx": 0}}
    info["t5"] = {"min_tokens": 0, "max_tokens": 6, "type": "seq_emb",
                  "id": generate_uint15_hash("t5"),
                  "embed_spec": {"kind": "sequence_emb", "max_length": 6, "orig_emb_dim": 16,
                                 "use_bottleneck": bottleneck, "bottleneck_dim": 8}}
    for m in info:
        info[m] = dict(info[m], input_alphas=[1.0], target_alphas=[0.0 if m == "t5" else 1.0])
    return info


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    return load_text_tokenizer(write_wordpiece_json(
        str(tmp_path_factory.mktemp("tok") / "tokenizer.json"), WORDS, num_sentinels=16))


def make_batch(info, tok, batch=2, seed=0):
    masking = UnifiedMasking(info, N_IN, N_TGT, None, seed=seed, text_tokenizer=tok)
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(batch):
        s = {m: rng.integers(0, info[m]["vocab_size"], info[m]["max_tokens"]).astype(np.int32)
             for m in ("tok_rgb", "tok_cam")}
        s["caption"] = " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), 9))
        s["t5"] = rng.normal(size=(5, 16)).astype(np.float32)
        samples.append(masking(s))
    return {m: {k: np.stack([s[m][k] for s in samples]) for k in samples[0][m]}
            for m in info}


def to_jax(md):
    return {m: {k: jnp.asarray(v) for k, v in d.items()} for m, d in md.items()}


def to_torch(md):
    return {m: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for m, d in md.items()}


def build(name, info, md, **kw):
    ins = MODS + ("t5",)
    jmodel = jax_create_model(name, ins, MODS, modality_info=info, **SMALL, **kw)
    params = jmodel.init(jax.random.PRNGKey(0), to_jax(md), N_IN, N_TGT)
    tmodel = create_model(name, ins, MODS, modality_info=info, **SMALL, **kw)
    tmodel.load_state_dict(egom2p_state_dict_from_jax(params, tmodel))
    return jmodel, params, tmodel


CASES = {"default": (NAME, {}, False), "no_sep_mask": (NAME, {"decoder_sep_mask": False}, False),
         "unshared_mod_emb": (NAME, {"share_modality_embeddings": False}, True),
         "causal": (CAUSAL, {}, False)}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(tok, case):
    name, kw, bottleneck = CASES[case]
    info = seq_info(bottleneck)
    md = make_batch(info, tok)
    assert (~md["caption"]["target_mask"]).any() and (~md["caption"]["input_mask"]).any()
    jmodel, params, tmodel = build(name, info, md, **kw)
    if case == "causal":
        assert tmodel.config.decoder_causal_mask and jmodel.config.decoder_causal_mask
    (jloss, jmods), jgrads = jax.value_and_grad(
        lambda p: jmodel.apply(p, to_jax(md), N_IN, N_TGT, "mod"), has_aux=True)(params)
    tloss, tmods = tmodel(to_torch(md), N_IN, N_TGT, "mod")
    tloss.backward()
    assert abs(float(tloss) - float(jloss)) < LOSS_ATOL
    for m in MODS:
        assert abs(float(tmods[m]) - float(jmods[m])) < LOSS_ATOL, m
    ref = egom2p_state_dict_from_jax(jgrads, tmodel)
    checked = 0
    for key, p in tmodel.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        r = ref[key].numpy()
        scale = max(float(np.abs(r).max()), 1e-12)
        assert float(np.abs(g - r).max()) <= GRAD_TOL * scale, key
        checked += 1
    names = dict(tmodel.named_parameters())
    assert "encoder_embeddings.t5.emb_proj" + (".0.weight" if bottleneck else ".weight") in names
    if case == "unshared_mod_emb":
        assert names["decoder_embeddings.caption.mod_emb"] is not \
            names["encoder_embeddings.caption.mod_emb"]
    assert float(names["decoder_embeddings.caption.token_emb.weight"].grad.abs().max()) > 0
    assert checked > 40


@pytest.mark.parametrize("causal,sep", [(False, True), (False, False), (True, True),
                                        (True, False)])
def test_decoder_attention_mask_matches_jax(tok, causal, sep):
    info = seq_info()
    md = make_batch(info, tok, seed=3)
    name = CAUSAL if causal else NAME
    jmodel, params, tmodel = build(name, info, md, decoder_sep_mask=sep)
    got = tmodel.forward_mask_decoder(tmodel.embed_decoder(to_torch(md)), N_TGT)
    ref = jmodel.apply(params, to_jax(md), N_TGT, method=lambda m, d, n: m.forward_mask_decoder(
        m.embed_decoder(d), n))
    for i in (0, 1, 3, 5):
        np.testing.assert_allclose(got[i].detach().numpy(), np.asarray(ref[i]), atol=1e-6)
    assert got[4].shape == (2, N_TGT, N_TGT)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


def test_registry_holds_the_causal_model():
    assert port_egom2p.MODEL_REGISTRY[CAUSAL] == JAX_REGISTRY[CAUSAL]
    assert set(JAX_REGISTRY) <= set(port_egom2p.MODEL_REGISTRY)


def test_pth_round_trip_with_caption_embeddings(tok, tmp_path):
    """Weights carried from JAX parameters and then through a .pth in the
    reference's key names give the same loss and autoregressive logits."""
    info = seq_info()
    md = make_batch(info, tok, seed=5)
    _, _, tmodel = build(NAME, info, md)
    keys = tmodel.state_dict()
    for k in ("encoder_embeddings.caption.token_emb.weight", "encoder_embeddings.caption.mod_emb",
              "decoder_embeddings.caption.token_emb.weight", "decoder_embeddings.caption.mod_emb",
              "encoder_embeddings.t5.emb_proj.weight", "encoder_embeddings.t5.emb_proj.bias"):
        assert k in keys, k
    save_checkpoint(str(tmp_path), "final", tmodel)
    again = create_model(NAME, MODS + ("t5",), MODS, modality_info=info, **SMALL)
    load_egom2p_pth(str(tmp_path / "checkpoint-final.pth"), again)
    with torch.no_grad():
        a = tmodel(to_torch(md), N_IN, N_TGT)[0]
        b = again(to_torch(md), N_IN, N_TGT)[0]
        assert torch.equal(a, b)
        ctx, mask = tmodel.forward_enc_context(to_torch(md), 32)
        ids = torch.randint(0, CAPTION_VOCAB, (2, 8), generator=torch.Generator().manual_seed(0))
        pos = torch.randn(2, 8, 192, generator=torch.Generator().manual_seed(1))
        assert torch.equal(tmodel.forward_dec_autoregressive_logits("caption", ids, pos, ctx, mask),
                           again.forward_dec_autoregressive_logits("caption", ids, pos, ctx, mask))


def test_placeholder_batches_beside_a_caption(tok):
    """A dataset without captions gets the caption's placeholder: the
    mixture's batch stacks, and the model takes a caption row with nothing
    visible and no target."""
    info = seq_info()
    md = make_batch(info, tok, batch=1)
    empty = make_empty_mod_entry(info["caption"])
    mixed = copy.deepcopy(md)
    mixed["caption"] = {k: np.concatenate([md["caption"][k], empty[k][None]])
                        for k in empty}
    for m in ("tok_rgb", "tok_cam", "t5"):
        mixed[m] = {k: np.concatenate([v, v]) for k, v in md[m].items()}
    _, _, tmodel = build(NAME, info, mixed)
    loss, mods = tmodel(to_torch(mixed), N_IN, N_TGT)
    assert np.isfinite(float(loss)) and set(mods) == set(MODS)
