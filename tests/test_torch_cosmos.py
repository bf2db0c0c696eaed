"""Cosmos DV tokenizer (encode half and weight transfer) in the PyTorch port
against the JAX package (the decode half: tests/test_torch_cosmos_decode.py).

The JAX tokenizer's random init is moved into the port with
compat/from_jax.py; a seeded uint8 clip goes through both at float32, at the
small topology of tests/test_cosmos.py (channels 16, mults (1, 2, 2),
z_channels 8, 64 px).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egom2p_torch.compat.from_jax import cosmos_state_dict_from_jax
from egom2p_torch.ops import fsq as tfsq
from egom2p_torch.ops import wavelet as twav
from egom2p_torch.tokenizers.cosmos.network import CausalDiscreteVideoTokenizer
from egom2p_torch.tokenizers.cosmos.network import DiscreteVideoConfig as TorchCfg
from egom2p_torch.tokenizers.cosmos.video_api import (CausalVideoTokenizer,
                                                      pad_video_window)
from egom2p_tpu.ops import fsq as jfsq
from egom2p_tpu.ops import wavelet as jwav
from egom2p_tpu.tokenizers.cosmos import CausalVideoTokenizer as JaxTokenizer
from egom2p_tpu.tokenizers.cosmos.network import DiscreteVideoConfig as JaxCfg

torch.set_num_threads(2)

SMALL = dict(channels=16, channels_mult=(1, 2, 2), z_channels=8)
# fp32 convs and norms in another summation order (oneDNN vs XLA:CPU);
# observed ~1e-6 on O(1) latents
LATENT_ATOL = 1e-4


def _near_boundary(fsq_levels, z, eps):
    """True where z +- eps quantizes differently: a rounding boundary of
    the bounded latent lies within eps of z (computed in float64)."""
    levels = np.asarray(fsq_levels, np.float64)
    half_l = (levels - 1) * (1 + 1e-3) / 2
    offset = np.where(levels % 2 == 0, 0.5, 0.0)
    shift = np.arctanh(offset / half_l)

    def q(x):
        return np.round(np.tanh(x.astype(np.float64) + shift) * half_l - offset)

    return (q(z - eps) != q(z + eps)).any(axis=-1)


@pytest.fixture(scope="module")
def tokenizers():
    jtok = JaxTokenizer.random_init(jax.random.PRNGKey(0), JaxCfg(**SMALL), frames=9,
                                    size=64, compute_dtype=jnp.float32)
    net = CausalDiscreteVideoTokenizer(TorchCfg(**SMALL))
    net.load_state_dict(cosmos_state_dict_from_jax(jtok.params, net))
    return jtok, CausalVideoTokenizer(net, torch.float32)


def test_cosmos_state_dict_from_jax(tokenizers):
    jtok, ttok = tokenizers
    sd = cosmos_state_dict_from_jax(jtok.params, ttok.net)
    assert set(sd) == set(ttok.net.state_dict())
    # the whole tokenizer, with no key left out: every JAX parameter has one
    assert len(sd) == len(jax.tree_util.tree_leaves(jtok.params))
    for key in ("encoder.mid.attn_1.1.proj_out.conv3d.weight",
                "encoder.down.0.block.0.norm1.norm.weight",
                "decoder.up.2.upsample.conv2.conv3d.weight", "decoder.up.0.block.2.conv2.1.conv3d.bias",
                "decoder.mid.attn_1.0.q.conv3d.weight", "decoder.norm_out.norm.bias",
                "post_quant_conv.conv3d.weight", "quant_conv.conv3d.weight"):
        assert key in sd, key
    assert not any(k.startswith("decoder.up.1.upsample") for k in sd)  # neither up here
    params = jax.tree_util.tree_map(np.asarray, jtok.params)
    params["params"]["encoder"]["stray"] = {"kernel": np.zeros((1, 1, 1, 1, 1))}
    with pytest.raises(KeyError):
        cosmos_state_dict_from_jax(params, ttok.net)


def test_patch3d_haar_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 9, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jwav.patch3d_haar(jnp.asarray(x), 4))
    got = twav.patch3d_haar(torch.from_numpy(x), 4).numpy()
    assert got.shape == ref.shape == (2, 3, 4, 4, 192)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_fsq_matches_jax():
    levels = (8, 8, 8, 5, 5, 5)
    z = (np.random.default_rng(1).standard_normal((4096, 6)) * 2).astype(np.float32)
    ji, jc = jfsq.FSQ(levels)(jnp.asarray(z))
    ti, tc = tfsq.FSQ(levels)(torch.from_numpy(z))
    safe = ~_near_boundary(levels, z, 1e-4)
    assert safe.mean() > 0.99
    np.testing.assert_array_equal(ti.numpy()[safe], np.asarray(ji)[safe])
    np.testing.assert_array_equal(tc.numpy()[safe], np.asarray(jc)[safe])
    assert ti.dtype == torch.int32 and 0 <= int(ti.min()) and int(ti.max()) < 64000
    # codes are exact multiples of 1 / half_width: the index is an exact sum
    half = np.asarray(levels) // 2
    np.testing.assert_array_equal(tc.numpy() * half, np.round(tc.numpy() * half))


def test_pad_video_window_matches_reference_padding():
    """16 frames of 60x52 -> edge-padded to 17 frames, zero-padded to 64x64
    with the reference's low/high split (egom2p_tpu pad_video_batch)."""
    from egom2p_tpu.tokenizers.cosmos.video_api import pad_video_batch
    v = np.random.default_rng(2).integers(0, 255, (1, 16, 60, 52, 3)).astype(np.uint8)
    ref, _ = pad_video_batch(v, 8, 16)
    got = pad_video_window(torch.from_numpy(v), 8, 16).numpy()
    np.testing.assert_array_equal(got, ref)


def test_encoder_latent_and_tokens_match_jax(tokenizers):
    jtok, ttok = tokenizers
    video = np.random.default_rng(3).integers(0, 255, (2, 16, 64, 64, 3)).astype(np.uint8)
    # pre-FSQ latent on the padded [-1, 1] window (17 frames)
    x = np.concatenate([video, video[:, -1:]], axis=1).astype(np.float32) / 127.5 - 1.0
    ref = np.asarray(jtok.module.apply(
        jtok.params, jnp.asarray(x),
        method=lambda m, x: m.quant_conv(m.encoder(x))))
    with torch.no_grad():
        got = ttok.net.encode_latent(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 5, 8, 8, 6)
    np.testing.assert_allclose(got, ref, atol=LATENT_ATOL, rtol=0)

    # uint8 in, tokens out, through the windowed API on both sides
    jtokens = np.asarray(jtok.forward(video))
    ttokens = ttok.forward(video)
    assert ttokens.shape == jtokens.shape == (2, 5, 8, 8) and ttokens.dtype == np.int32
    safe = ~_near_boundary(jtok.module.cfg.levels, ref, 1e-4)
    assert safe.mean() > 0.9
    np.testing.assert_array_equal(ttokens[safe], jtokens[safe])


def test_forward_sliding_window_and_device_out(tokenizers):
    """A 20-frame clip is two windows: 17 frames (5 latent frames) and 3
    frames edge-padded to 9 (3 latent frames), as in the JAX package."""
    jtok, ttok = tokenizers
    video = np.random.default_rng(4).integers(0, 255, (1, 20, 64, 64, 3)).astype(np.uint8)
    tokens = ttok.forward(torch.from_numpy(video), device_out=True)
    assert isinstance(tokens, torch.Tensor)
    assert tuple(tokens.shape) == np.asarray(jtok.forward(video)).shape == (1, 8, 8, 8)
    np.testing.assert_array_equal(tokens[:, :5].numpy(), ttok.forward(video[:, :17]))
