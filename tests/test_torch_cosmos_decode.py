"""Cosmos DV tokenizer decode half in the PyTorch port against the JAX package,
and the port's default encode precision against the JAX package's default.

At the small topology of tests/test_torch_cosmos.py (channels 16, mults
(1, 2, 2), z_channels 8, 64 px); the JAX tokenizer's random init is moved
into the port with compat/from_jax.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egom2p_torch.compat.from_jax import cosmos_state_dict_from_jax
from egom2p_torch.ops import fsq as tfsq
from egom2p_torch.ops import wavelet as twav
from egom2p_torch.tokenizers.cosmos.layers import CausalHybridUpsample3d
from egom2p_torch.tokenizers.cosmos.network import CausalDiscreteVideoTokenizer
from egom2p_torch.tokenizers.cosmos.network import DiscreteVideoConfig as TorchCfg
from egom2p_torch.tokenizers.cosmos.video_api import CausalVideoTokenizer, tensor2numpy
from egom2p_tpu.ops import fsq as jfsq
from egom2p_tpu.ops import wavelet as jwav
from egom2p_tpu.tokenizers.cosmos import CausalVideoTokenizer as JaxTokenizer
from egom2p_tpu.tokenizers.cosmos import layers as jlayers
from egom2p_tpu.tokenizers.cosmos.network import DiscreteVideoConfig as JaxCfg
from egom2p_tpu.tokenizers.cosmos.video_api import tensor2numpy as jax_tensor2numpy

torch.set_num_threads(2)

SMALL = dict(channels=16, channels_mult=(1, 2, 2), z_channels=8)
# fp32 convs and norms in another summation order (oneDNN vs XLA:CPU)
LATENT_ATOL = 1e-4
WAVELET_ATOL = 1e-6    # adds and halvings of O(1) values in another order
UINT8_LEVELS = 1       # a rounding boundary between two fp32 results


@pytest.fixture(scope="module")
def tokenizers():
    """(JAX fp32, JAX default bf16, port fp32, port default) on one set of
    weights."""
    jtok = JaxTokenizer.random_init(jax.random.PRNGKey(0), JaxCfg(**SMALL), frames=9,
                                    size=64, compute_dtype=jnp.float32)
    jdefault = JaxTokenizer(jtok.params, JaxCfg(**SMALL))
    net = CausalDiscreteVideoTokenizer(TorchCfg(**SMALL))
    net.load_state_dict(cosmos_state_dict_from_jax(jtok.params, net))
    return jtok, jdefault, CausalVideoTokenizer(net, torch.float32), CausalVideoTokenizer(net)


def test_idwt3d_and_unpatch3d_haar_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 4, 192)).astype(np.float32)
    ref = np.asarray(jwav.idwt3d(jnp.asarray(x)))
    got = twav.idwt3d(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 6, 8, 8, 24)
    np.testing.assert_allclose(got, ref, atol=WAVELET_ATOL, rtol=0)
    ref = np.asarray(jwav.unpatch3d_haar(jnp.asarray(x), 4))
    got = twav.unpatch3d_haar(torch.from_numpy(x), 4).numpy()
    assert got.shape == ref.shape == (2, 9, 16, 16, 3)
    np.testing.assert_allclose(got, ref, atol=WAVELET_ATOL, rtol=0)


def test_patch_then_unpatch_is_the_identity():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 9, 16, 16, 3))
                         .astype(np.float32))
    np.testing.assert_allclose(twav.unpatch3d_haar(twav.patch3d_haar(x, 4), 4).numpy(),
                               x.numpy(), atol=WAVELET_ATOL, rtol=0)
    y = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 4, 8, 8, 16))
                         .astype(np.float32))
    np.testing.assert_allclose(twav.idwt3d(twav.dwt3d(y)).numpy(), y.numpy(),
                               atol=WAVELET_ATOL, rtol=0)


def test_indices_to_codes_exact_for_every_index():
    levels = (8, 8, 8, 5, 5, 5)
    idx = np.arange(64000, dtype=np.int32).reshape(4, 16000)
    ref = np.asarray(jfsq.FSQ(levels).indices_to_codes(jnp.asarray(idx)))
    q = tfsq.FSQ(levels)
    got = q.indices_to_codes(torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (4, 16000, 6)
    np.testing.assert_array_equal(got.numpy(), ref)
    # and back: codes_to_indices inverts it on every index
    np.testing.assert_array_equal(q.codes_to_indices(got).numpy(), idx)


@pytest.mark.parametrize("spatial,temporal,T", [(1, 1, 3), (1, 0, 3), (0, 1, 3), (1, 1, 1),
                                                (0, 1, 1)])
def test_hybrid_upsample_matches_jax(spatial, temporal, T):
    """T = 1 takes no temporal repeat (time_factor 1); otherwise T frames
    become 2T - 1.  Residual adds around conv1 and conv2, conv3 always."""
    C = 8
    x = np.random.default_rng(3).standard_normal((2, T, 4, 4, C)).astype(np.float32)
    jmod = jlayers.CausalHybridUpsample3d(spatial_up=bool(spatial), temporal_up=bool(temporal))
    variables = jmod.init(jax.random.PRNGKey(T), jnp.asarray(x))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    tmod = CausalHybridUpsample3d(C, spatial_up=bool(spatial), temporal_up=bool(temporal))
    tmod.load_state_dict(cosmos_state_dict_from_jax(variables, tmod))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).numpy()
    t_out = 2 * T - 1 if temporal and T > 1 else T
    assert got.shape == ref.shape == (2, t_out, 8 if spatial else 4, 8 if spatial else 4, C)
    np.testing.assert_allclose(got, ref, atol=LATENT_ATOL, rtol=0)


def test_decode_code_matches_jax(tokenizers):
    jtok, _, ttok, _ = tokenizers
    idx = np.random.default_rng(4).integers(0, 64000, (2, 3, 8, 8)).astype(np.int32)
    ref = np.asarray(jtok.decode(jnp.asarray(idx)))
    got = ttok.decode(idx)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape == (2, 9, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=LATENT_ATOL, rtol=0)
    diff = np.abs(tensor2numpy(got).astype(int) - jax_tensor2numpy(ref).astype(int))
    assert diff.max() <= UINT8_LEVELS
    # the default tokenizer (bf16 encode input) decodes in fp32 too
    np.testing.assert_array_equal(tokenizers[3].decode(idx).numpy(), got.numpy())


def test_reconstruct_two_windows_matches_jax(tokenizers):
    """A 20-frame clip is two windows (17 and 3 frames, padded to 17 and 9):
    uint8 frames out, of the input's length, within one level of JAX's."""
    _, jdefault, _, tdefault = tokenizers
    video = np.random.default_rng(5).integers(0, 256, (1, 20, 64, 64, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tdefault.forward(video), np.asarray(jdefault.forward(video)))
    ref = jdefault.reconstruct(video)
    got = tdefault.reconstruct(video)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (1, 20, 64, 64, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= UINT8_LEVELS


def test_default_tokenize_equals_jax_default_on_every_token(tokenizers):
    """The port's default tokenizer (bf16 input and Haar patch, fp32 network
    and FSQ) against the JAX package's default CausalVideoTokenizer
    (compute_dtype bf16, fp32 parameters): every token equal."""
    _, jdefault, ttok32, tdefault = tokenizers
    assert tdefault.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tdefault.net.parameters())
    video = np.random.default_rng(6).integers(0, 256, (2, 16, 64, 64, 3)).astype(np.uint8)
    ref = np.asarray(jdefault.forward(video))
    got = tdefault.forward(video)
    assert got.shape == ref.shape == (2, 5, 8, 8)
    np.testing.assert_array_equal(got, ref)
    # the all-fp32 tokenizer is another computation: it is not what JAX's default gives
    assert (ttok32.forward(video) != ref).any()
