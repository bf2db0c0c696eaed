"""The port's cam / gaze VQ-VAE tokenizers and VQ lookup against the JAX
package, on the CPU at a small width (dim 128, 2 heads of 64, depth 2; 60
frames -> 30 tokens of 256 codes, latent 32, as released), fp32 in both.

* tokenize: equal tokens wherever the top-1 / top-2 cosine gap of the JAX
  latents exceeds TIE_GAP (an argmax that close may flip with the order of
  fp32 sums); the count under it is printed;
* decode_tokens and autoencode: within DECODE_ATOL;
* vq_lookup (cosine and euclidean) and indices_to_embedding: equal;
* a reference-format .pth written here reads through the JAX package's
  loader (egom2p_tpu.compat.torch_convert.load_seq_vqvae_pth) and the
  port's, to the same decode; the port's state-dict keys are exactly the
  keys the JAX converter reads.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egom2p_tpu.tokenizers.seq_vqvae as jseq
from egom2p_torch.compat.from_jax import seq_vqvae_state_dict_from_jax
from egom2p_torch.core import checkpoint
from egom2p_torch.data.cam_gaze import smooth_cam_trajectories
from egom2p_torch.ops import vq as tvq
from egom2p_torch.tokenizers import seq_vqvae as tseq
from egom2p_tpu.compat import torch_convert
from egom2p_tpu.ops import vq as jvq

torch.set_num_threads(2)

SMALL = dict(dim=128, depth=2, num_heads=2)
TIE_GAP = 1e-5
# fp32 through 2 + 2 blocks in two libraries: 3.8e-6 max observed
DECODE_ATOL = 1e-5
# at the released width (12 + 12 blocks of 768, outputs up to about 5):
# 1.14e-5 max observed
FULL_WIDTH_ATOL = 5e-5
IN_CHANNELS = {"cam": 9, "gaze": 2}  # the conv's: gaze drops its validity channel


def make_inputs(domain, rng, batch=4):
    """Seeded tokenizer inputs: cam (B, 60, 9) (two smooth trajectories and
    the rest standard normal); gaze (B, 60, 3) (x, y in [-1, 1], a validity
    channel with about a fifth of the frames invalid)."""
    if domain == "cam":
        x = rng.standard_normal((batch, 60, 9)).astype(np.float32)
        x[:2] = smooth_cam_trajectories(rng, 2)[0]  # canonicalised and standardised
        return x
    x = rng.uniform(-1, 1, (batch, 60, 3)).astype(np.float32)
    x[..., 2] = rng.uniform(size=(batch, 60)) > 0.2
    return x


@functools.lru_cache(maxsize=None)
def pair(domain, seed=0):
    """A JAX tokenizer at SMALL width and the port's with its weights."""
    jt = jseq.seq_vqvae_from_config(domain, jax.random.PRNGKey(seed), **SMALL)
    tt = tseq.seq_vqvae_from_config(domain, **SMALL)
    tt.net.load_state_dict(seq_vqvae_state_dict_from_jax(jt.params, jt.vq_state, tt))
    return jt, tt


def _clear(jt, x):
    """Positions whose top-1 / top-2 cosine gap on the JAX latents exceeds
    TIE_GAP."""
    lat = jt.module.apply(jt.params, jnp.asarray(x), method=jseq.SeqAutoencoder.encode_latents)
    sims = np.asarray(jvq.l2norm(lat) @ jvq.l2norm(jt.vq_state.embed).T)
    top2 = np.sort(sims, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > TIE_GAP


@pytest.mark.parametrize("domain", ["cam", "gaze"])
def test_tokens_match_jax(domain):
    jt, tt = pair(domain)
    x = make_inputs(domain, np.random.default_rng(1), batch=8)
    jtok = np.asarray(jt.tokenize(jnp.asarray(x)))
    ttok = tt.tokenize(x)
    assert ttok.shape == (8, 30) and ttok.device.type == "cpu"
    clear = _clear(jt, x)
    print(f"{domain}: {int((~clear).sum())} of {clear.size} positions within {TIE_GAP} "
          f"of a tie")
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(ttok.numpy()[clear], jtok[clear])


@pytest.mark.parametrize("domain", ["cam", "gaze"])
def test_decode_and_autoencode_match_jax(domain):
    jt, tt = pair(domain)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, (4, 30))
    jrec = np.asarray(jt.decode_tokens(jnp.asarray(tokens)))
    trec = tt.decode_tokens(tokens)
    out_c = 9 if domain == "cam" else 2
    assert tuple(trec.shape) == jrec.shape == (4, 60, out_c) and trec.dtype == torch.float32
    np.testing.assert_allclose(trec.numpy(), jrec, atol=DECODE_ATOL, rtol=0)

    x = make_inputs(domain, rng)
    # rows whose every position is clear of a tie have the same tokens
    rows = _clear(jt, x).all(axis=1)
    assert rows.sum() >= 3
    ja = np.asarray(jt.autoencode(jnp.asarray(x)))
    ta = tt.autoencode(x).numpy()
    np.testing.assert_allclose(ta[rows], ja[rows], atol=DECODE_ATOL, rtol=0)


def test_gaze_validity_channel_masks_the_input():
    """Invalid frames' x, y do not reach the encoder: (data * mask)."""
    _, tt = pair("gaze")
    x = make_inputs("gaze", np.random.default_rng(3))
    y = x.copy()
    y[..., :2] = np.where(y[..., 2:] > 0, y[..., :2], 123.0)
    torch.testing.assert_close(tt.net.encode_latents(torch.from_numpy(y)),
                               tt.net.encode_latents(torch.from_numpy(x)), rtol=0, atol=0)


@pytest.mark.parametrize("cosine", [True, False])
def test_vq_lookup_matches_jax(cosine):
    rng = np.random.default_rng(4)
    cfg_j = jvq.VQConfig(codebook_size=256, dim=32, use_cosine_sim=cosine)
    cfg_t = tvq.VQConfig(codebook_size=256, dim=32, use_cosine_sim=cosine)
    embed = rng.standard_normal((256, 32)).astype(np.float32)
    x = rng.standard_normal((3, 30, 32)).astype(np.float32) * 2
    js = jvq.VQState(embed=jnp.asarray(embed), cluster_size=jnp.zeros(256),
                     initted=jnp.ones((), bool))
    ts = tvq.VQState(embed=torch.from_numpy(embed), cluster_size=torch.zeros(256),
                     initted=torch.ones(1))
    jq, ji = jvq.vq_lookup(cfg_j, js, jnp.asarray(x))
    tq, ti = tvq.vq_lookup(cfg_t, ts, torch.from_numpy(x))
    assert tuple(tq.shape) == (3, 30, 32) and tuple(ti.shape) == (3, 30)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the raw codebook rows, not their normalised form
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tq.numpy(), embed[ti.numpy()])
    ids = rng.integers(0, 256, (2, 30))
    np.testing.assert_array_equal(tvq.indices_to_embedding(ts, ids).numpy(),
                                  np.asarray(jvq.indices_to_embedding(js, jnp.asarray(ids))))


@pytest.mark.parametrize("cosine", [True, False])
def test_init_vq_state_matches_jax_distribution(cosine):
    """The port draws from its own generator: the same kaiming-uniform bound
    and l2 normalisation as the JAX init, not the same numbers."""
    cfg_t = tvq.VQConfig(codebook_size=256, dim=32, use_cosine_sim=cosine)
    cfg_j = jvq.VQConfig(codebook_size=256, dim=32, use_cosine_sim=cosine)
    ts = tvq.init_vq_state(cfg_t, torch.Generator().manual_seed(0))
    js = jvq.init_vq_state(cfg_j, jax.random.PRNGKey(0))
    assert tuple(ts.embed.shape) == js.embed.shape
    assert bool(ts.initted.all()) and bool(js.initted)
    tn = torch.linalg.vector_norm(ts.embed, dim=-1).numpy()
    jn = np.linalg.norm(np.asarray(js.embed), axis=-1)
    if cosine:
        np.testing.assert_allclose(tn, 1.0, atol=1e-6)
        np.testing.assert_allclose(jn, 1.0, atol=1e-6)
    else:
        bound = np.sqrt(3.0) * np.sqrt(2.0 / 32)
        for e in (ts.embed.numpy(), np.asarray(js.embed)):
            assert np.abs(e).max() <= bound and np.abs(e).max() > 0.9 * bound


class _Recorder(dict):
    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


@pytest.mark.parametrize("domain", ["cam", "gaze"])
def test_state_dict_keys_are_the_reference_keys(domain):
    """Every key of the port's state dict is one the JAX converter reads
    from a reference checkpoint, with its shape, and none is missing."""
    jt, tt = pair(domain)
    sd = _Recorder({k: v.numpy() for k, v in tt.net.state_dict().items()})
    params, vq = torch_convert.convert_seq_vqvae_state_dict(sd, jax.device_get(jt.params))
    assert sd.read == set(sd)
    assert tuple(sd["quant_proj.weight"].shape) == (32, 128, 1)
    assert tuple(sd["encoder.conv.weight"].shape) == (128, IN_CHANNELS[domain], 2)
    np.testing.assert_array_equal(vq["embed"], np.asarray(jt.vq_state.embed))


@pytest.mark.parametrize("domain", ["cam", "gaze"])
def test_reference_pth_loads_in_both_packages(domain, tmp_path, monkeypatch):
    """A .pth in the reference layout ({"model": sd}) of a port tokenizer
    with its own random weights: the JAX package's loader (at this width)
    and the port's give the same decode."""
    tok = tseq.seq_vqvae_from_config(domain, torch.Generator().manual_seed(5), **SMALL)
    path = checkpoint.save_seq_vqvae_pth(tok, str(tmp_path / f"checkpoint-{domain}.pth"))
    monkeypatch.setattr(jseq, "seq_vqvae_from_config",
                        functools.partial(jseq.seq_vqvae_from_config, **SMALL))
    jt = torch_convert.load_seq_vqvae_pth(path, domain)
    tt = checkpoint.load_seq_vqvae_pth(path, domain, "cpu", **SMALL)
    for k, v in tok.net.state_dict().items():
        torch.testing.assert_close(tt.net.state_dict()[k], v, rtol=0, atol=0)
    tokens = np.random.default_rng(6).integers(0, 256, (2, 30))
    np.testing.assert_allclose(tt.decode_tokens(tokens).numpy(),
                               np.asarray(jt.decode_tokens(jnp.asarray(tokens))),
                               atol=DECODE_ATOL, rtol=0)
    x = make_inputs(domain, np.random.default_rng(7))
    np.testing.assert_array_equal(tt.tokenize(x).numpy(), tok.tokenize(x).numpy())


def test_loader_checks_every_key(tmp_path):
    tok = tseq.seq_vqvae_from_config("cam", torch.Generator().manual_seed(0), **SMALL)
    sd = dict(tok.net.state_dict())
    # a bare state dict, a fixed pos_emb table and a one-element flag of
    # another shape are accepted
    bare = dict(sd, **{"encoder.pos_emb": torch.zeros(1, 30, 128),
                       "quantize._codebook.initted": torch.tensor(True)})
    torch.save(bare, tmp_path / "bare.pth")
    checkpoint.load_seq_vqvae_pth(str(tmp_path / "bare.pth"), "cam", "cpu", **SMALL)
    for name, bad, match in (
            ("missing", {k: v for k, v in sd.items() if "blocks.1." not in k},
             r"missing \['encoder.blocks.1"),
            ("extra", dict(sd, **{"decoder.extra.weight": torch.zeros(1)}),
             r"left over \['decoder.extra.weight'\]")):
        torch.save({"model": bad}, tmp_path / f"{name}.pth")
        with pytest.raises(KeyError, match=match):
            checkpoint.load_seq_vqvae_pth(str(tmp_path / f"{name}.pth"), "cam", "cpu", **SMALL)
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.load_seq_vqvae_pth(str(tmp_path / "bare.pth"), "gaze", "cpu", **SMALL)
    with pytest.raises(ValueError, match="unknown seq-vqvae domain"):
        tseq.seq_vqvae_from_config("depth")


@pytest.mark.slow
@pytest.mark.parametrize("domain", ["cam", "gaze"])
def test_reference_pth_at_the_released_width(domain, tmp_path):
    """dim 768, 12 + 12 blocks, 12 heads: the JAX package's loader as it
    ships, and the port's defaults."""
    tok = tseq.seq_vqvae_from_config(domain, torch.Generator().manual_seed(5))
    assert sum(p.numel() for p in tok.net.parameters()) > 150e6
    path = checkpoint.save_seq_vqvae_pth(tok, str(tmp_path / f"checkpoint-{domain}.pth"))
    jt = torch_convert.load_seq_vqvae_pth(path, domain)
    tt = checkpoint.load_seq_vqvae_pth(path, domain, "cpu")
    tokens = np.random.default_rng(6).integers(0, 256, (2, 30))
    np.testing.assert_allclose(tt.decode_tokens(tokens).numpy(),
                               np.asarray(jt.decode_tokens(jnp.asarray(tokens))),
                               atol=FULL_WIDTH_ATOL, rtol=0)
