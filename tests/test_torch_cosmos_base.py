"""The Cosmos video tokenizers beyond DV4x8x8's FACTORIZED network on the
port against the JAX package, on the CPU at small widths, the JAX weights
carried over by compat/from_jax.py:cosmos_state_dict_from_jax:

* DV with the BASE encoder and decoder (channels 16 x (1, 2), GroupNorm of
  4 groups, attention at the first level, Haar patch 2 per frame,
  compression 4 x 4 x 4): the reference's key layout; at fp32 every token
  equal and the decode within LATENT_ATOL of its largest; at the JAX
  default precision (bf16 input and patch, fp32 network) every token equal;
* CV at temporal compression 8 and 4 (the decoder's channels_mult (2, 4)
  at 4), AE and VAE (the mean, and a sample on JAX's normal draws), with
  the FACTORIZED network (channels 16 x (1, 2, 2)): latents and
  reconstructions within LATENT_ATOL at fp32 and at the JAX default (bf16
  input and patch; the latent rounded to bf16 before the decoder, as JAX's
  `_decode` casts it: compared on JAX's rounded latent), uint8
  reconstructions of a two-window clip within UINT8_LEVELS.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egom2p_torch.compat.from_jax import cosmos_state_dict_from_jax
from egom2p_torch.tokenizers.cosmos import network as tnet
from egom2p_torch.tokenizers.cosmos.video_api import (CausalVideoTokenizer,
                                                      ContinuousVideoTokenizer)
from egom2p_tpu.tokenizers.cosmos import network as jnet
from egom2p_tpu.tokenizers.cosmos import video_api as japi

torch.set_num_threads(2)

BASE = dict(channels=16, channels_mult=(1, 2), num_res_blocks=1, resolution=64, patch_size=2,
            num_groups=4, spatial_compression=4, temporal_compression=4, z_channels=8,
            encoder="BASE", decoder="BASE")
CV = dict(channels=16, channels_mult=(1, 2, 2), num_res_blocks=1, z_channels=8,
          latent_channels=4)
LATENT_ATOL = 1e-4   # fp32 convs and norms in another summation order (oneDNN vs XLA:CPU)
UINT8_LEVELS = 1


def _close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= atol, f"{what}: {err:.2e} of its max"


@pytest.fixture(scope="module")
def base_pair():
    jcfg = jnet.DiscreteVideoConfig(**BASE)
    j32 = japi.CausalVideoTokenizer.random_init(jax.random.PRNGKey(0), jcfg, frames=9, size=32,
                                                compute_dtype=jnp.float32)
    jdef = japi.CausalVideoTokenizer(j32.params, jcfg)
    jdef._decode_code = j32._decode_code  # indices in, whatever the compute dtype
    net = tnet.CausalDiscreteVideoTokenizer(tnet.DiscreteVideoConfig(**BASE))
    net.load_state_dict(cosmos_state_dict_from_jax(j32.params, net))
    return j32, jdef, CausalVideoTokenizer(net, torch.float32), CausalVideoTokenizer(net)


def test_base_state_dict_is_the_reference_layout(base_pair):
    j32, _, t32, _ = base_pair
    sd = t32.net.state_dict()
    assert len(sd) == len(jax.tree_util.tree_leaves(j32.params))
    for key in ("encoder.conv_in.conv3d.weight", "encoder.down.0.block.0.conv1.conv3d.weight",
                "encoder.down.1.block.0.nin_shortcut.conv3d.weight",
                "encoder.down.0.attn.0.q.conv3d.weight",
                "encoder.down.0.downsample.conv.conv3d.bias",
                "encoder.mid.attn_1.proj_out.conv3d.weight", "encoder.norm_out.norm.weight",
                "decoder.up.1.upsample.conv.conv3d.weight",
                "decoder.up.0.block.1.conv2.conv3d.bias",
                "decoder.conv_out.conv3d.weight"):
        assert key in sd, key


def test_base_tokens_and_decode_match_jax(base_pair):
    j32, jdef, t32, tdef = base_pair
    video = np.random.default_rng(1).integers(0, 256, (2, 9, 32, 32, 3), dtype=np.uint8)
    ref = np.asarray(j32.forward(video))
    got = t32.forward(video)
    assert got.shape == ref.shape == (2, 3, 8, 8)
    np.testing.assert_array_equal(got, ref)
    _close(t32.decode(got).numpy(), j32.decode(jnp.asarray(ref)), LATENT_ATOL, "decode")
    np.testing.assert_array_equal(tdef.forward(video), np.asarray(jdef.forward(video)))


CV_CASES = {"CV8x8x8-AE": dict(temporal_compression=8),
            "CV4x8x8-AE": dict(temporal_compression=4),
            "CV8x8x8-VAE": dict(temporal_compression=8, formulation="VAE", z_factor=2),
            "CV4x8x8-VAE": dict(temporal_compression=4, formulation="VAE", z_factor=2)}


@pytest.mark.parametrize("case", list(CV_CASES))
def test_continuous_video_matches_jax(case):
    over = dict(CV, **CV_CASES[case])
    jcfg = jnet.ContinuousVideoConfig(**over)
    j32 = japi.ContinuousVideoTokenizer.random_init(jax.random.PRNGKey(2), jcfg, frames=17,
                                                    size=32, compute_dtype=jnp.float32)
    jdef = japi.ContinuousVideoTokenizer(j32.params, jcfg)
    net = tnet.CausalContinuousVideoTokenizer(tnet.ContinuousVideoConfig(**over))
    net.load_state_dict(cosmos_state_dict_from_jax(j32.params, net))
    if over["temporal_compression"] == 4:  # the decoder's two levels
        assert len(net.decoder.up) == 2 and len(net.encoder.down) == 3
    t32, tdef = ContinuousVideoTokenizer(net, torch.float32), ContinuousVideoTokenizer(net)
    x = np.random.default_rng(3).uniform(-1, 1, (1, 17, 32, 32, 3)).astype(np.float32)
    (j_lat,), (t_lat,) = j32.encode(x), t32.encode(x)
    t = 17 // over["temporal_compression"] + 1
    assert tuple(t_lat.shape) == (1, t, 4, 4, 4)
    _close(t_lat.numpy(), j_lat, LATENT_ATOL, "latent (the VAE's mean)")
    _close(t32.decode(t_lat).numpy(), j32.decode(j_lat), LATENT_ATOL, "decode")
    # the JAX default: the latent before its bf16 rounding, and the decode of
    # JAX's bf16-rounded latent (a latent within an fp32 ulp of a bf16
    # rounding edge may round the other way on either side)
    (jd_lat,), (td_lat,) = jdef.encode(x), tdef.encode(x)
    _close(td_lat.numpy(), np.asarray(jd_lat), LATENT_ATOL, "default latent")
    _close(tdef.decode(torch.from_numpy(np.asarray(jd_lat))).numpy(), jdef.decode(jd_lat),
           LATENT_ATOL, "default decode")
    if case == "CV8x8x8-AE":  # window by window over 20 frames (17 + 3 padded to 9), uint8
        video = np.random.default_rng(4).integers(0, 256, (1, 20, 32, 32, 3), dtype=np.uint8)
        got, ref = t32.forward(video), np.asarray(j32.forward(video))
        assert got.shape == video.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= UINT8_LEVELS
    if over.get("formulation") == "VAE":  # a sample on JAX's normal draws
        key = jax.random.PRNGKey(9)
        j_s, (j_mu, j_logvar) = jax.jit(lambda p, x: j32.module.apply(
            p, x, key, method=jnet.CausalContinuousVideoTokenizer.encode))(j32.params,
                                                                           jnp.asarray(x))
        noise = torch.from_numpy(np.array(jax.random.normal(key, j_mu.shape, j_mu.dtype)))
        with torch.no_grad():
            t_s, (_, t_logvar) = net.encode(torch.from_numpy(x), noise=noise)
        _close(t_s.numpy(), j_s, LATENT_ATOL, "sample")
        _close(t_logvar.numpy(), j_logvar, LATENT_ATOL, "logvar")
