"""The Cosmos image tokenizers (CI / DI) on the port against the JAX package,
on the CPU at the JAX tests' TINY config (tests/test_image_tokenizer.py:
channels 32 x (1, 2), attention at 8, one block a level, resolution 32,
Haar patch 2, spatial compression 4), the JAX weights carried over by
compat/from_jax.py:cosmos_image_state_dict_from_jax:

* the 2-D wavelet and rearrange patchers and the 3-D rearrange patcher:
  bitwise;
* DI with each quantizer (FSQ, RESFSQ, LFQ, VQ) and CI (AE, VAE on its mean
  and on JAX's normal draws passed in), in fp32: every token equal, codes,
  latents and reconstructions within LATENT_ATOL of their largest; at the
  JAX default precision (bf16 input and Haar patch, fp32 network; CI's
  latent rounded to bf16 before the decoder): every token equal, uint8
  reconstructions within UINT8_LEVELS;
* load_cosmos_image_pth on traced encoder.jit / decoder.jit files and on a
  whole-network .pth that the test writes, in both packages;
* python -m egom2p_torch.cli.tokenize_images against the root
  tokenize_images.py on PNGs the test writes, both build_tokenizer
  functions patched to TINY with the same weights: _codes.npy bitwise,
  reconstructions within one uint8 level.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egom2p_torch.compat.from_jax import cosmos_image_state_dict_from_jax
from egom2p_torch.core import checkpoint
from egom2p_torch.ops import wavelet as twav
from egom2p_torch.tokenizers.cosmos import image_network as tnet
from egom2p_torch.tokenizers.cosmos.image_api import ImageTokenizer
from egom2p_tpu.ops import wavelet as jwav
from egom2p_tpu.tokenizers.cosmos import image_network as jnet
from egom2p_tpu.tokenizers.cosmos.image_api import ImageTokenizer as JaxImageTokenizer

torch.set_num_threads(2)

TINY = dict(channels=32, channels_mult=(1, 2), attn_resolutions=(8,), num_res_blocks=1,
            resolution=32, patch_size=2, spatial_compression=4, z_channels=16, embedding_dim=6)
QUANTIZERS = {"FSQ": {}, "RESFSQ": dict(num_quantizers=3), "LFQ": dict(codebook_dim=10),
              "VQ": dict(num_embeddings=32)}
# fp32 convs and GroupNorms in another summation order (oneDNN vs XLA:CPU)
LATENT_ATOL = 1e-4
UINT8_LEVELS = 1

_CACHE = {}


def tokenizers(discrete=True, **over):
    """(JAX fp32, JAX default, port fp32, port default) tokenizers on the
    same random weights."""
    key = (discrete, tuple(sorted(over.items())))
    if key not in _CACHE:
        cls_j = jnet.DiscreteImageTokenizer if discrete else jnet.ContinuousImageTokenizer
        cls_t = tnet.DiscreteImageTokenizer if discrete else tnet.ContinuousImageTokenizer
        jcfg = jnet.ImageTokenizerConfig(**TINY, **over)
        params = jax.jit(lambda k: cls_j(jcfg).init(k, jnp.zeros((1, 32, 32, 3))))(
            jax.random.PRNGKey(len(_CACHE)))
        net = cls_t(tnet.ImageTokenizerConfig(**TINY, **over))
        net.load_state_dict(cosmos_image_state_dict_from_jax(params, net))
        j32 = JaxImageTokenizer(params, jcfg, discrete, compute_dtype=jnp.float32)
        jdef = JaxImageTokenizer(params, jcfg, discrete)
        if discrete:  # decode_code takes indices whatever the compute dtype: one compile
            jdef._decode_code = j32._decode_code
        _CACHE[key] = (j32, jdef, ImageTokenizer(net, torch.float32), ImageTokenizer(net))
    return _CACHE[key]


def _close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= atol, f"{what}: {err:.2e} of its max"


@pytest.mark.parametrize("name", ["dwt2d", "patch2d_haar", "patch2d_rearrange",
                                  "patch3d_rearrange"])
def test_patchers_match_jax(name):
    x = np.random.default_rng(0).standard_normal((2, 5, 8, 12, 3)).astype(np.float32)
    fwd = {"dwt2d": ("dwt2d", "idwt2d", ()),
           "patch2d_haar": ("patch2d_haar", "unpatch2d_haar", (4,)),
           "patch2d_rearrange": ("patch2d_rearrange", "unpatch2d_rearrange", (2,)),
           "patch3d_rearrange": ("patch3d_rearrange", "unpatch3d_rearrange", (2,))}[name]
    f, inv, extra = fwd
    if name == "patch3d_rearrange":  # the causal clip: 1 + 2k frames
        x = x[:, :5]
    ref = np.asarray(getattr(jwav, f)(jnp.asarray(x), *extra))
    got = getattr(twav, f)(torch.from_numpy(x), *extra)
    np.testing.assert_array_equal(got.numpy(), ref)
    back = getattr(twav, inv)(got, *extra).numpy()
    np.testing.assert_array_equal(back, np.asarray(getattr(jwav, inv)(jnp.asarray(ref), *extra)))
    np.testing.assert_allclose(back, x, atol=1e-6, rtol=0)


def test_state_dict_from_jax_is_the_reference_layout():
    _, _, t32, _ = tokenizers(True, quantizer="VQ", num_embeddings=32)
    sd = t32.net.state_dict()
    for key in ("encoder.down.0.block.0.norm1.weight", "encoder.down.0.downsample.conv.weight",
                "encoder.down.1.attn.0.q.weight", "encoder.mid.attn_1.norm.bias",
                "decoder.up.1.upsample.conv.weight", "decoder.up.1.attn.1.proj_out.weight",
                "quant_conv.weight", "post_quant_conv.bias", "quantizer.embedding.weight"):
        assert key in sd, key
    params = jax.tree_util.tree_map(np.asarray, tokenizers(True, quantizer="VQ",
                                                           num_embeddings=32)[0].params)
    params["params"]["encoder"]["stray"] = {"kernel": np.zeros((1, 1, 1, 1))}
    with pytest.raises(KeyError):
        cosmos_image_state_dict_from_jax(params, t32.net)


@pytest.mark.parametrize("quantizer", list(QUANTIZERS))
def test_discrete_matches_jax(quantizer):
    j32, jdef, t32, tdef = tokenizers(True, quantizer=quantizer, **QUANTIZERS[quantizer])
    # images of 29 x 31 pad to the 32 x 32 the encoder calls below see: one compile each
    img = np.random.default_rng(2).integers(0, 256, (2, 29, 31, 3), dtype=np.uint8)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    j_idx, j_codes = j32.encode(x)
    t_idx, t_codes = t32.encode(x)
    shape = (2, 3, 8, 8) if quantizer == "RESFSQ" else (2, 8, 8)
    assert tuple(t_idx.shape) == np.asarray(j_idx).shape == shape
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    _close(t_codes.numpy(), j_codes, LATENT_ATOL, "codes")
    _close(t32.decode(t_idx).numpy(), j32.decode(j_idx), LATENT_ATOL, "decode")
    # the JAX default: bf16 input and patch, fp32 network; every token equal
    np.testing.assert_array_equal(tdef.encode(x)[0].numpy(), np.asarray(jdef.encode(x)[0]))
    got, ref = tdef.forward(img), np.asarray(jdef.forward(img))
    assert got.shape == img.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= UINT8_LEVELS


@pytest.mark.parametrize("formulation", ["AE", "VAE"])
def test_continuous_matches_jax(formulation):
    over = dict(formulation=formulation, z_factor=2 if formulation == "VAE" else 1,
                latent_channels=8)
    j32, jdef, t32, tdef = tokenizers(False, **over)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    (j_lat,), (t_lat,) = j32.encode(x), t32.encode(x)
    assert tuple(t_lat.shape) == (2, 8, 8, 8)
    _close(t_lat.numpy(), j_lat, LATENT_ATOL, "latent (the VAE's mean)")
    _close(t32.decode(t_lat).numpy(), j32.decode(j_lat), LATENT_ATOL, "decode")
    _close(tdef.encode(x)[0].float().numpy(), np.asarray(jdef.encode(x)[0], np.float32),
           LATENT_ATOL, "default latent")
    img = np.random.default_rng(4).integers(0, 256, (2, 29, 31, 3), dtype=np.uint8)
    got, ref = tdef.forward(img), np.asarray(jdef.forward(img))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= UINT8_LEVELS
    if formulation == "VAE":  # a sample on JAX's normal draws
        key = jax.random.PRNGKey(9)
        j_s, (j_mu, j_logvar) = jax.jit(lambda p, x: j32.module.apply(
            p, x, rng=key, method=jnet.ContinuousImageTokenizer.encode))(j32.params, jnp.asarray(x))
        noise = torch.from_numpy(np.array(jax.random.normal(key, j_mu.shape, j_mu.dtype)))
        with torch.no_grad():
            t_s, (t_mu, t_logvar) = t32.net.encode(torch.from_numpy(x), noise=noise)
        _close(t_s.numpy(), j_s, LATENT_ATOL, "sample")
        _close(t_logvar.numpy(), j_logvar, LATENT_ATOL, "logvar")


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """The FSQ DI tokenizer as encoder.jit / decoder.jit and as a .pth."""
    _, _, t32, _ = tokenizers(True)
    d = tmp_path_factory.mktemp("cosmos_image")
    checkpoint.save_cosmos_image_jit(t32.net, str(d), size=32)
    torch.save(t32.net.state_dict(), d / "di.pth")
    return d


@pytest.mark.parametrize("form", ["jit", "pth"])
def test_load_cosmos_image_pth_in_both_packages(image_files, form):
    from egom2p_tpu.compat import torch_convert

    d = image_files
    paths = ((str(d / "encoder.jit"), str(d / "decoder.jit")) if form == "jit"
             else (str(d / "di.pth"), None))
    jcfg, tcfg = jnet.ImageTokenizerConfig(**TINY), tnet.ImageTokenizerConfig(**TINY)
    jtok = torch_convert.load_cosmos_image_pth(*paths, cfg=jcfg)
    ttok = checkpoint.load_cosmos_image_pth(*paths, cfg=tcfg, device="cpu")
    for k, v in tokenizers(True)[2].net.state_dict().items():
        assert torch.equal(ttok.net.state_dict()[k], v), k
    x = np.random.default_rng(5).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttok.encode(x)[0].numpy(), np.asarray(jtok.encode(x)[0]))
    if form == "jit":  # an encoder.jit alone leaves the decoder's weights out
        with pytest.raises(KeyError, match="missing"):
            checkpoint.load_cosmos_image_pth(paths[0], cfg=tcfg, device="cpu")


def test_tokenize_images_cli_matches_the_root_script(tmp_path, monkeypatch):
    from PIL import Image

    import tokenize_images as root_cli
    from egom2p_torch.cli import tokenize_images as port_cli

    rs = np.random.RandomState(5)
    for i in range(2):
        Image.fromarray(rs.randint(0, 255, (40, 44, 3), np.uint8)).save(tmp_path / f"img_{i}.png")
    _, jdef, _, tdef = tokenizers(True)
    monkeypatch.setattr(root_cli, "build_tokenizer", lambda args: jdef)
    monkeypatch.setattr(port_cli, "build_tokenizer", lambda args, device: tdef)
    flags = ["--image_pattern", str(tmp_path / "*.png"), "--tokenizer_type", "DI",
             "--save_input", "--save_codes"]
    root_cli.main(flags + ["--output_dir", str(tmp_path / "jax")])
    port_cli.main(flags + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    for i in range(2):
        want = np.load(tmp_path / "jax" / f"img_{i}_codes.npy")
        got = np.load(tmp_path / "port" / f"img_{i}_codes.npy")
        assert got.dtype == want.dtype and got.shape == want.shape == (10, 11)
        np.testing.assert_array_equal(got, want)
        rec = [np.asarray(Image.open(tmp_path / side / f"img_{i}.png")).astype(int)
               for side in ("jax", "port")]
        assert rec[1].shape == (40, 44, 3)
        assert np.abs(rec[0] - rec[1]).max() <= UINT8_LEVELS
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / f"img_{i}_input.png")),
            np.asarray(Image.open(tmp_path / f"img_{i}.png")))
    # without --save_codes the reconstruction comes from tokenize.forward
    port_cli.main(flags[:-1] + ["--output_dir", str(tmp_path / "fwd"), "--device", "cpu"])
    assert not (tmp_path / "fwd" / "img_0_codes.npy").exists()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "fwd" / "img_0.png")),
                                  np.asarray(Image.open(tmp_path / "port" / "img_0.png")))
    # the real build_tokenizer: random weights from a seed, and a missing checkpoint
    args = port_cli.parse_args(["--image_pattern", "x", "--random_init", "--device", "cpu",
                                "--spatial_compression", "8"])
    monkeypatch.undo()
    tok = port_cli.build_tokenizer(args, torch.device("cpu"))
    assert tok.cfg == tnet.DI8x8_CONFIG and tok.discrete
    with pytest.raises(SystemExit, match="checkpoint"):
        port_cli.build_tokenizer(port_cli.parse_args(["--image_pattern", "x", "--device", "cpu"]),
                                 torch.device("cpu"))
    if not torch.cuda.is_available():  # --device defaults to cuda: no CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main(["--image_pattern", str(tmp_path / "*.png"), "--random_init"])
