"""models/{lora,hub}.py, the untied vocab head, forward_dec_subset_logits,
make_fid / make_inception_score and the card as the helpers' default
device, against the JAX package.

The tiny registry model at float32 on the dense attention path (32 tokens
a video modality), JAX weights moved over by compat/from_jax.py.
Tolerances, measured here: LoRA's merged weights within 1e-6 (one
product's rounding), the loss within 1e-5 relative and the adapters'
gradients within 1e-4 of each tensor's largest entry (the dense forward
agrees to ~4e-6, tests/test_torch_model.py); the untied head's loss and
logits likewise; FM.from_pretrained's weights bitwise from every layout
(the registry model's bf16 loss within 5e-3); FID and the Inception score
within 1e-6 relative on the same InceptionV3 features.
"""
import argparse
import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egom2p_tpu.models.egom2p as jax_egom2p
import egom2p_tpu.ops.flash_attention as jax_fa
from egom2p_torch.compat.from_jax import egom2p_state_dict_from_jax, lora_state_from_jax
from egom2p_torch.core import checkpoint
from egom2p_torch.core import image_metrics as TM
from egom2p_torch.core import inception_v3 as tinc
from egom2p_torch.core import vgg_features as tvgg
from egom2p_torch.models import lora as tlora
from egom2p_torch.models import teachers as tteach
from egom2p_torch.models.egom2p import create_model
from egom2p_torch.models.hub import FM
from egom2p_tpu.core import image_metrics as JM
from egom2p_tpu.models import lora as jlora
from egom2p_tpu.models.egom2p import EgoM2P as JaxEgoM2P
from egom2p_tpu.models.egom2p import create_model as jax_create_model
from egom2p_tpu.models.embeddings import make_decoder_embedding as jax_make_decoder_embedding
from egom2p_tpu.models.hub import FM as JaxFM
from tests.test_torch_model import MODS4, NAME, make_mod_dict, tiny_info, to_jax, to_torch

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_LOSS_RTOL = 5e-3   # the registry model's bf16 compute (measured 7e-4)


def _pair(info, seed=0, mods=MODS4):
    jmodel = jax_create_model(NAME, mods, mods, modality_info=info, compute_dtype="float32")
    md = make_mod_dict(np.random.default_rng(seed), info)
    md = {m: md[m] for m in mods}
    n = info[mods[0]]["max_tokens"]
    with mock.patch.object(jax_fa, "supports_flash", lambda: False):
        params = jmodel.init(jax.random.PRNGKey(seed), to_jax(md), n, n)
    tmodel = create_model(NAME, mods, mods, modality_info=info, compute_dtype="float32")
    tmodel.load_state_dict(egom2p_state_dict_from_jax(params, tmodel))
    return jmodel, params, tmodel.eval(), md


def _close_to_max(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= tol * scale, (name, np.abs(got - want).max() / scale)


@pytest.fixture(scope="module")
def lora_setup():
    info = tiny_info()
    jmodel, params, tmodel, md = _pair(info)
    jl = jlora.init_lora_params(params, jax.random.PRNGKey(1), rank=2)
    # b = 0 makes a's gradient 0: give b values so both are tested
    rng = np.random.default_rng(2)
    jl = {k: {"a": v["a"], "b": jnp.asarray(rng.normal(0, 0.02, v["b"].shape), jnp.float32)}
          for k, v in jl.items()}
    return jmodel, params, tmodel, md, jl


def test_lora_init_targets_and_layout(lora_setup):
    _, params, tmodel, _, jl = lora_setup
    tl = tlora.init_lora_params(dict(tmodel.named_parameters()), torch.Generator().manual_seed(0),
                                rank=2)
    converted = lora_state_from_jax(jl)
    assert set(tl) == set(converted) and len(tl) == 6 * 2 + 6 * 5
    assert {k.split(".", 2)[2].rsplit(".", 1)[0] for k in tl} == {
        "attn.qkv", "attn.proj", "self_attn.qkv", "self_attn.proj", "cross_attn.q",
        "cross_attn.kv", "cross_attn.proj"}
    for k, ab in tl.items():
        assert ab["a"].shape == converted[k]["a"].shape and ab["b"].shape == converted[k]["b"].shape
        assert not ab["b"].any()
    a = torch.cat([ab["a"].reshape(-1) for ab in tl.values()])
    assert abs(a.std().item() - 0.5) < 0.02  # N(0, 1) / rank


def test_lora_merge_and_gradients_match_jax(lora_setup):
    jmodel, params, tmodel, md, jl = lora_setup
    n = tiny_info()["tok_rgb"]["max_tokens"]
    tl = lora_state_from_jax(jl)
    base = {k: v.detach() for k, v in tmodel.named_parameters()}
    merged_t = tlora.merge_lora(base, tl, scale=0.7)
    merged_j = egom2p_state_dict_from_jax(jlora.merge_lora(params, jl, scale=0.7), tmodel)
    for k, v in merged_j.items():
        if k in merged_t:
            _close_to_max(merged_t[k], v, 1e-6, k)
    assert set(tl) < set(merged_t)

    j_loss_fn = jlora.lora_train_step_fn(lambda p, m: jmodel.apply(p, m, n, n, "mod")[0],
                                         params, scale=0.7)
    j_loss, j_grad = jax.value_and_grad(j_loss_fn)(jl, to_jax(md))
    leaves = {k: {n_: v.clone().requires_grad_(True) for n_, v in ab.items()}
              for k, ab in tl.items()}
    apply = tlora.lora_train_step_fn(tmodel, scale=0.7)
    t_loss, _ = apply(leaves, to_torch(md), n, n, "mod")
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=LOSS_RTOL)
    assert all(p.grad is None for p in tmodel.parameters())  # the base stays frozen
    j_grad = lora_state_from_jax(j_grad)
    for k in leaves:
        for part in ("a", "b"):
            _close_to_max(leaves[k][part].grad, j_grad[k][part], GRAD_TOL, f"{k}.{part}")
    # merge_lora then the plain model: the adapted forward's loss
    with torch.no_grad():
        fused = torch.func.functional_call(tmodel, merged_t, (to_torch(md), n, n, "mod"))[0]
    np.testing.assert_allclose(fused.item(), t_loss.item(), rtol=1e-6)


def _untied(info, mods=("tok_depth", "tok_gaze")):
    info = copy.deepcopy(info)
    for m in mods:
        info[m]["embed_spec"]["share_embedding"] = False
    info["tok_depth"].update(vocab_size=4096)  # the flash-CE route (V >= 4096, D % 128 == 0)
    info["tok_depth"]["embed_spec"]["vocab_size"] = 4096
    return info


def test_untied_head_matches_jax(monkeypatch):
    """share_embedding=False on two decoder embeddings (JAX builds them
    through make_decoder_embedding(..., share_embedding=False)): to_logits
    carried by from_jax, the training loss (the port's flash-CE route, its
    plain version here, reading to_logits) and the subset logits."""
    monkeypatch.setattr(jax_egom2p, "make_decoder_embedding", lambda spec, dim: (
        jax_make_decoder_embedding(spec, dim, spec.get("share_embedding", True))))
    info = _untied(tiny_info())
    jmodel, params, tmodel, md = _pair(info, seed=3)
    n = info["tok_rgb"]["max_tokens"]
    assert "to_logits" in params["params"]["decoder_embeddings_tok_depth"]
    emb = tmodel.decoder_embeddings
    assert emb["tok_depth"].logits_weight is emb["tok_depth"].to_logits.weight
    assert emb["tok_rgb"].logits_weight is emb["tok_rgb"].token_emb.weight
    assert not torch.equal(emb["tok_depth"].to_logits.weight,
                           emb["tok_depth"].token_emb.weight)
    j_loss, j_mod = jmodel.apply(params, to_jax(md), n, n, "mod")
    t_loss, t_mod = tmodel(to_torch(md), n, n, "mod")
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=LOSS_RTOL)
    for m in MODS4:
        np.testing.assert_allclose(t_mod[m].item(), float(j_mod[m]), rtol=LOSS_RTOL)
    t_loss.backward()
    assert emb["tok_depth"].to_logits.weight.grad.abs().max() > 0
    _subset_logits_check(jmodel, params, tmodel, md, n)


def _subset_logits_check(jmodel, params, tmodel, md, n):
    """forward_dec_subset_logits = forward_mod_logits(forward_dec_subset_hidden)
    in the port, and JAX's within the tolerance."""
    L = tmodel.mod_info["tok_depth"]["max_tokens"]
    ids_keep = np.stack([np.random.default_rng(r).permutation(L)[:7] for r in (4, 5)])
    ids_keep = ids_keep.astype(np.int32)
    jmd, tmd = to_jax(md), to_torch(md)
    ctx, mask = jmodel.apply(params, jmd, n, method=JaxEgoM2P.forward_enc_context)
    want = np.asarray(jmodel.apply(params, jmd, "tok_depth", ctx, mask, jnp.asarray(ids_keep),
                                   method=JaxEgoM2P.forward_dec_subset_logits))
    with torch.no_grad():
        tctx, tmask = tmodel.forward_enc_context(tmd, n)
        keep = torch.from_numpy(ids_keep)
        got = tmodel.forward_dec_subset_logits(tmd, "tok_depth", tctx, tmask, keep)
        y = tmodel.forward_dec_subset_hidden(tmd, "tok_depth", tctx, tmask, keep)
        torch.testing.assert_close(got, tmodel.forward_mod_logits("tok_depth", y), rtol=0, atol=0)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close_to_max(got.numpy(), want, 1e-5, "subset logits")


def test_forward_dec_subset_logits_matches_jax_tied():
    info = tiny_info()
    jmodel, params, tmodel, md = _pair(info, seed=6)
    _subset_logits_check(jmodel, params, tmodel, md, info["tok_rgb"]["max_tokens"])


# --------------------------------------------------------------------- hub
SEQ_MODS = ("tok_cam", "tok_gaze")   # the released 256-token heads: a small file


@pytest.fixture(scope="module")
def hub_pair():
    from egom2p_tpu.data.modality_info import MODALITY_INFO
    return _pair(MODALITY_INFO, seed=7, mods=SEQ_MODS)


def _equal_sd(model, ref_sd):
    sd = model.state_dict()
    assert set(sd) == set(ref_sd)
    for k, v in ref_sd.items():
        assert torch.equal(sd[k], v), k


def test_from_pretrained_every_layout(hub_pair, tmp_path, monkeypatch):
    jmodel, params, tmodel, md = hub_pair
    ref = {k: v.clone() for k, v in tmodel.state_dict().items()}
    fm = FM(tmodel)
    for sub, weights in (("st", "model.safetensors"), ("bin", "pytorch_model.bin"),
                         ("pth", "ckpt.pth")):
        fm.save_pretrained(str(tmp_path / sub), weights)
        _equal_sd(FM.from_pretrained(str(tmp_path / sub), device="cpu").model, ref)
    # the JAX package reads the same directory (its safetensors package)
    jfm = JaxFM.from_pretrained(str(tmp_path / "st"))
    _equal_sd(tmodel, egom2p_state_dict_from_jax(jfm.params, tmodel))
    # a bare .pth with the reference's pickled args (the registry model)
    bare = tmp_path / "bare.pth"
    torch.save({"model": ref, "args": argparse.Namespace(
        model=NAME, in_domains=list(SEQ_MODS), out_domains=list(SEQ_MODS))}, bare)
    _equal_sd(FM.from_pretrained(str(bare), device="cpu").model, ref)
    # a hub id in the local cache: refs/main names the snapshot
    hub = tmp_path / "hf" / "hub" / "models--org--egom2p" / "snapshots"
    for rev in ("aaa", "zzz"):
        fm.save_pretrained(str(hub / rev), "model.safetensors")
    torch.nn.init.zeros_(tmodel.mask_token)  # the "zzz" snapshot differs from "aaa"
    fm.save_pretrained(str(hub / "zzz"), "model.safetensors")
    tmodel.load_state_dict(ref)
    (hub.parent / "refs").mkdir()
    (hub.parent / "refs" / "main").write_text("aaa\n")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    loaded = FM.from_pretrained("org/egom2p", device="cpu")
    _equal_sd(loaded.model, ref)
    n = 8
    with torch.no_grad():
        a = loaded(to_torch(md), n, n, "mod")[0]
        b = tmodel(to_torch(md), n, n, "mod")[0]
    assert torch.equal(a, b)
    # what no layout holds
    (tmp_path / "orbax").mkdir()
    fm.save_pretrained(str(tmp_path / "orbax"), "model.safetensors")
    (tmp_path / "orbax" / "model.safetensors").unlink()
    with pytest.raises(ValueError, match="orbax"):
        FM.from_pretrained(str(tmp_path / "orbax"), device="cpu")
    with pytest.raises(RuntimeError, match="nothing is downloaded"):
        FM.from_pretrained("org/absent", device="cpu")
    torch.save({"model": ref}, tmp_path / "noargs.pth")
    with pytest.raises(ValueError, match="pickled args"):
        FM.from_pretrained(str(tmp_path / "noargs.pth"), device="cpu")


def test_jax_written_tree_as_pth(hub_pair, tmp_path):
    """A JAX-written parameter tree, converted by compat/from_jax.py and
    saved as the reference's .pth: the port's FM and the JAX package's FM
    load the same weights, and the forward agrees."""
    jmodel, params, tmodel, md = hub_pair
    fresh = jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.5, params)
    sd = egom2p_state_dict_from_jax(fresh, tmodel)
    path = tmp_path / "jax_tree.pth"
    torch.save({"model": sd, "args": argparse.Namespace(
        model=NAME, in_domains=list(SEQ_MODS), out_domains=list(SEQ_MODS))}, path)
    fm = FM.from_pretrained(str(path), device="cpu")
    _equal_sd(fm.model, sd)
    jfm = JaxFM.from_pretrained(str(path))
    _equal_sd(fm.model, egom2p_state_dict_from_jax(jfm.params, fm.model))
    n = 8  # the registry model computes in bf16 on both sides: bf16 noise
    j_loss, _ = jfm(to_jax(md), n, n, "mod")
    t_loss, _ = fm(to_torch(md), n, n, "mod")
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=BF16_LOSS_RTOL)


# ------------------------------------------------------ FID / Inception score
def test_make_fid_and_inception_score_match_jax(tmp_path, monkeypatch):
    """The port's defaults take get_inception_fns(device) (the seeded
    inception_v3.npz's network on the CPU, held against JAX's graph by
    tests/test_torch_image_metrics.py::test_inception_matches_jax); both
    packages' make_fid / make_inception_score get the same features and
    probabilities, so the accumulators and the score's arithmetic are
    compared here."""
    np.savez(tmp_path / "inception_v3.npz", **tinc.random_weights(np.random.default_rng(8)))
    monkeypatch.setenv("EGOM2P_CKPT_DIR", str(tmp_path))
    rng = np.random.default_rng(9)
    real = rng.uniform(0, 1, (3, 40, 40, 3)).astype(np.float32)
    fake = np.clip(real + rng.normal(0, 0.2, real.shape), 0, 1).astype(np.float32)
    _, _, run = TM.get_inception_fns(device="cpu")
    seen = {}  # each batch through the network once (the CPU graph takes ~1 s an image)

    def memo(images, i):
        key = images.tobytes()
        if key not in seen:
            seen[key] = run(images)
        return seen[key][i]

    def feature_fn(images):  # 32 of the 2048 pool3 features: scipy's sqrtm of a 2048^2
        return memo(images, 0)[:, :32]  # covariance takes ~25 s on the CPU

    def probs_fn(images):
        return memo(images, 1)

    monkeypatch.setattr(TM, "get_inception_fns", lambda device: (feature_fn, probs_fn, run))
    t_fid, j_fid = TM.make_fid(device="cpu"), JM.make_fid(feature_fn)
    for acc in (t_fid, j_fid):
        acc.update(real, real=True)
        acc.update(fake, real=False)
    np.testing.assert_allclose(t_fid.compute(), j_fid.compute(), rtol=1e-6)
    t_is = TM.make_inception_score(splits=3, device="cpu")(fake)
    j_is = JM.make_inception_score(probs_fn, splits=3)(fake)
    np.testing.assert_allclose(t_is, j_is, rtol=1e-6)
    assert t_fid.compute() > 0 and t_is >= 1.0
    # a feature / probability function of the caller's needs no device
    assert TM.make_fid(lambda x: x.reshape(len(x), -1)) is not None


# -------------------------------------------------- the card as the default
def _helpers(tmp_path):
    w = tinc.random_weights(np.random.default_rng(10))
    x = np.zeros((1, 8, 8, 3), np.float32)
    reg = TM.register_default_perceptual_metrics()  # registering needs no device
    return {
        "make_lpips": lambda: TM.make_lpips(),
        "get_inception_fns": lambda: TM.get_inception_fns(),
        "get_lpips": lambda: TM.get_lpips(),
        "make_perceptual_loss": lambda: TM.make_perceptual_loss(),
        "registered lpips": lambda: reg["lpips"](x, x),
        "make_fid": lambda: TM.make_fid(),
        "make_inception_score": lambda: TM.make_inception_score(),
        "make_inception_fns": lambda: tinc.make_inception_fns(w),
        "vgg16_features": lambda: tvgg.vgg16_features(x, {}),
        "load_seq_vqvae_pth": lambda: checkpoint.load_seq_vqvae_pth(str(tmp_path / "x.pth"),
                                                                     "cam"),
        "FM.from_pretrained": lambda: FM.from_pretrained(str(tmp_path)),
        "load_cosmos_dv_pth": lambda: checkpoint.load_cosmos_dv_pth(str(tmp_path / "e.jit")),
        "load_cosmos_image_pth": lambda: checkpoint.load_cosmos_image_pth(
            str(tmp_path / "e.jit")),
        "load_teacher_pth": lambda: tteach.load_teacher_pth(str(tmp_path / "t.pth"),
                                                            "CLIP-B16"),
        "get_feature_extractor": lambda: tteach.get_feature_extractor("CLIP-B16"),
    }


HELPERS = ["make_lpips", "get_inception_fns", "get_lpips", "make_perceptual_loss",
           "registered lpips", "make_fid", "make_inception_score", "make_inception_fns",
           "vgg16_features", "load_seq_vqvae_pth", "FM.from_pretrained", "load_cosmos_dv_pth",
           "load_cosmos_image_pth", "load_teacher_pth", "get_feature_extractor"]


@pytest.mark.parametrize("helper", HELPERS)
def test_helpers_default_to_the_card(helper, tmp_path, monkeypatch):
    """Without a CUDA device a helper given no device raises, naming
    device="cpu", before it looks for any file: nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    helpers = _helpers(tmp_path)
    assert sorted(helpers) == sorted(HELPERS)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        helpers[helper]()
