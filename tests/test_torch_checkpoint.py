"""Checkpoints of the PyTorch port against the JAX package's readers.

* a reference-format EgoM2P .pth (with the reference's persistent pos_emb
  buffers) loads into both packages with the same outputs; a missing key or
  a wrong shape raises;
* the port trainer's checkpoints are readable by the JAX package's readers;
* a Cosmos .pth and a TorchScript encoder.jit / decoder.jit pair load into
  both packages with the same tokens and decoded video;
* resume is bitwise on the CPU, and --finetune copies what matches.
"""
import argparse
import shutil
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import egom2p_tpu.ops.flash_attention as jax_fa
from egom2p_torch.cli import run_training
from egom2p_torch.compat.from_jax import cosmos_state_dict_from_jax, egom2p_state_dict_from_jax
from egom2p_torch.core import checkpoint
from egom2p_torch.models.egom2p import create_model
from egom2p_torch.tokenizers.cosmos.network import CausalDiscreteVideoTokenizer
from egom2p_torch.tokenizers.cosmos.network import DiscreteVideoConfig as TorchCfg
from egom2p_tpu.compat import torch_convert
from egom2p_tpu.data.modality_info import make_scaled_modality_info as jax_scaled_info
from egom2p_tpu.models.egom2p import create_model as jax_create_model
from egom2p_tpu.tokenizers.cosmos import CausalVideoTokenizer as JaxTokenizer
from egom2p_tpu.tokenizers.cosmos.network import DiscreteVideoConfig as JaxCfg
from egom2p_tpu.tokenizers.cosmos.video_api import tensor2numpy as jax_tensor2numpy

from test_torch_cosmos_decode import LATENT_ATOL, SMALL, UINT8_LEVELS
from test_torch_model import (HIDDEN_ATOL, MODS4, NAME, _jax_hooks, _torch_hooks,
                              assert_hidden_close, dense_models, make_mod_dict)  # noqa: F401

torch.set_num_threads(2)


def _reference_pth(path, module, **args):
    """The reference's checkpoint layout: the state dict with its persistent
    pos_emb buffers, and the argparse namespace."""
    sd = dict(module.state_dict())
    sd.update({k: v.clone() for k, v in module.named_buffers() if k.endswith(".pos_emb")})
    torch.save({"model": sd, "epoch": 0, "args": argparse.Namespace(**args)}, path)
    return sd


def _jax_load(path, jmodel):
    torch_convert._PTH_CACHE.clear()  # one load per (path, mtime): keep files apart
    with mock.patch.object(jax_fa, "supports_flash", lambda: False):
        return torch_convert.load_egom2p_pth(str(path), jmodel)


def test_reference_pth_loads_into_both_packages_alike(dense_models, tmp_path):
    _, _, src = dense_models
    info = src.mod_info
    path = tmp_path / "ref.pth"
    sd = _reference_pth(path, src, model=NAME, in_domains=list(MODS4), out_domains=list(MODS4))
    assert any(k.endswith(".pos_emb") for k in sd)

    jmodel = jax_create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32")
    jparams = _jax_load(path, jmodel)
    tmodel = create_model(NAME, MODS4, MODS4, modality_info=info, compute_dtype="float32")
    tmodel.init_random_(torch.Generator().manual_seed(7))
    checkpoint.load_egom2p_pth(str(path), tmodel)
    for k, v in src.state_dict().items():
        assert torch.equal(tmodel.state_dict()[k], v), k
    assert checkpoint.read_pth_args(str(path)).model == NAME

    rng = np.random.default_rng(11)
    md = make_mod_dict(rng, info)
    ids_keep = np.stack([rng.permutation(32)[:20] for _ in range(2)]).astype(np.int32)
    ref = _jax_hooks(jmodel, jparams, {m: {k: jnp.asarray(v) for k, v in d.items()}
                                        for m, d in md.items()}, 48, ids_keep)
    got = _torch_hooks(tmodel.eval(), {m: {k: torch.from_numpy(np.asarray(v))
                                           for k, v in d.items()} for m, d in md.items()},
                       48, ids_keep)
    for name, g, r in zip(("context", "mask", "decoder hidden", "logits"), got, ref):
        assert_hidden_close(g, r, name, max_atol=HIDDEN_ATOL)


@pytest.mark.parametrize("fault", ["missing", "shape", "extra"])
def test_reference_pth_faults_raise(dense_models, tmp_path, fault):
    _, _, src = dense_models
    sd = dict(src.state_dict())
    key = "decoder_embeddings.tok_depth.token_emb.weight"
    if fault == "missing":
        del sd[key]
    elif fault == "shape":
        sd[key] = sd[key][:-1]
    else:
        sd["encoder.0.attn.stray.weight"] = torch.zeros(3)
    path = tmp_path / f"{fault}.pth"
    torch.save({"model": sd}, path)
    tmodel = create_model(NAME, MODS4, MODS4, modality_info=src.mod_info)
    with pytest.raises(ValueError if fault == "shape" else KeyError, match="EgoM2P weights"):
        checkpoint.load_egom2p_pth(str(path), tmodel)


TRAIN = ["--synthetic_data", "--scaled_modalities", "--model", NAME, "--num_input_tokens", "32",
         "--num_target_tokens", "32", "--batch_size", "2", "--epoch_size", "2",
         "--device", "cpu", "--print_freq", "100"]


def _train(out, *more, on_step=None):
    return run_training.main(run_training.get_args(TRAIN + ["--output_dir", str(out), *more]),
                             on_step=on_step)


def test_trainer_checkpoint_is_read_by_the_jax_package(tmp_path):
    """checkpoint-{epoch}.pth every --save_ckpt_freq epochs and
    checkpoint-final.pth: the reference's format, so the JAX package's
    readers rebuild the trained model."""
    run = _train(tmp_path, "--epochs", "3", "--save_ckpt_freq", "2")
    assert sorted(p.name for p in tmp_path.glob("checkpoint-*")) == [
        "checkpoint-1.pth", "checkpoint-final.pth"]
    path = tmp_path / "checkpoint-final.pth"
    torch_convert._PTH_CACHE.clear()
    ns = torch_convert.read_pth_args(str(path))
    assert isinstance(ns, argparse.Namespace) and ns.model == NAME
    assert sorted(ns.in_domains) == sorted(ns.out_domains) == sorted(MODS4)
    ckpt = checkpoint.load_pth(str(path))
    assert ckpt["step"] == 3 and ckpt["epoch"] == 2 and "optimizer" in ckpt
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("checkpoint-1.pth")

    jmodel = jax_create_model(ns.model, tuple(sorted(ns.in_domains)),
                              tuple(sorted(ns.out_domains)), modality_info=jax_scaled_info())
    jparams = _jax_load(path, jmodel)
    back = egom2p_state_dict_from_jax(jparams, run["model"])
    for k, v in run["model"].state_dict().items():
        assert torch.equal(back[k], v.cpu()), k


def test_resume_is_bitwise(tmp_path):
    """A run killed after its third step resumes from checkpoint-1.pth (two
    steps) in a fresh process state: its third step, on the same batch,
    gives parameters bitwise equal to an unbroken three-step run's."""
    unbroken = _train(tmp_path / "a", "--epochs", "3")

    class Killed(Exception):
        pass

    def kill(step, metrics, seconds):
        if step == 2:
            raise Killed

    with pytest.raises(Killed):
        _train(tmp_path / "b", "--epochs", "3", on_step=kill)
    assert checkpoint.latest_checkpoint(str(tmp_path / "b")).endswith("checkpoint-1.pth")
    resumed = _train(tmp_path / "b", "--epochs", "3")
    assert len(resumed["metrics"]) == 1
    assert resumed["metrics"][0] == unbroken["metrics"][2]
    assert resumed["optimizer"].step_count == 3
    for (k, a), b in zip(unbroken["model"].state_dict().items(),
                         resumed["model"].state_dict().values()):
        assert torch.equal(a, b), k
    # --no_auto_resume starts afresh in the same directory
    fresh = _train(tmp_path / "b", "--epochs", "1", "--no_auto_resume")
    assert fresh["metrics"][0] == unbroken["metrics"][0]


def test_finetune_skips_a_tensor_of_another_shape(tmp_path, capsys):
    src = create_model(NAME, sorted(MODS4), sorted(MODS4),
                       modality_info=run_training.modality_info(run_training.get_args(TRAIN)))
    src.init_random_(torch.Generator().manual_seed(3))
    sd = dict(src.state_dict())
    sd["mask_token"] = torch.zeros(1, 1, 7)
    path = tmp_path / "warm.pth"
    torch.save({"model": sd, "args": argparse.Namespace(model=NAME)}, path)

    run = _train(tmp_path / "run", "--epochs", "1", "--finetune", str(path), "--blr", "0")
    n = len(sd)
    assert f"warm start: copied {n - 1}/{n} tensors from {path}" in capsys.readouterr().out
    for k, v in run["model"].state_dict().items():
        if k == "mask_token":
            assert v.shape == (1, 1, 384)
        else:
            assert torch.equal(v, sd[k]), k  # a zero learning rate keeps the copy

    dst = create_model(NAME, sorted(MODS4), sorted(MODS4), modality_info=src.mod_info)
    before = dst.state_dict()["mask_token"].clone()
    assert checkpoint.warm_start(dst, str(path)) == (n - 1, n)
    assert torch.equal(dst.state_dict()["mask_token"], before)


class _EncoderJit(nn.Module):
    """The key layout of Cosmos's encoder.jit: encoder, quant_conv and the
    quantizer's buffers."""

    def __init__(self, net):
        super().__init__()
        self.encoder, self.quant_conv = net.encoder, net.quant_conv
        self.quantizer = nn.Module()
        self.quantizer.register_buffer("_levels", torch.tensor(net.cfg.levels))

    def forward(self, x):
        return self.quant_conv(self.encoder(x))


class _DecoderJit(nn.Module):
    def __init__(self, net):
        super().__init__()
        self.post_quant_conv, self.decoder = net.post_quant_conv, net.decoder
        self.inv_quant = nn.Module()
        self.inv_quant.quantizer = nn.Module()
        self.inv_quant.quantizer.register_buffer("_levels", torch.tensor(net.cfg.levels))

    def forward(self, z):
        return self.decoder(self.post_quant_conv(z))


@pytest.fixture(scope="module")
def cosmos_files(tmp_path_factory):
    jtok = JaxTokenizer.random_init(jax.random.PRNGKey(5), JaxCfg(**SMALL), frames=9, size=64)
    net = CausalDiscreteVideoTokenizer(TorchCfg(**SMALL)).eval()
    net.load_state_dict(cosmos_state_dict_from_jax(jtok.params, net))
    d = tmp_path_factory.mktemp("cosmos")
    torch.save(net.state_dict(), d / "cosmos.pth")
    with warnings.catch_warnings(), torch.no_grad():
        warnings.simplefilter("ignore")  # the tracer's notes on shape-dependent branches
        enc = torch.jit.trace(_EncoderJit(net), torch.zeros(1, 192, 2, 8, 8))
        dec = torch.jit.trace(_DecoderJit(net), torch.zeros(1, 6, 2, 4, 4))
    enc.save(str(d / "encoder.jit"))
    dec.save(str(d / "decoder.jit"))
    return d


@pytest.mark.parametrize("form", ["pth", "jit"])
def test_cosmos_checkpoints_load_into_both_packages_alike(cosmos_files, form):
    d = cosmos_files
    paths = ((str(d / "cosmos.pth"), None) if form == "pth"
             else (str(d / "encoder.jit"), str(d / "decoder.jit")))
    jtok = torch_convert.load_cosmos_dv_pth(*paths, cfg=JaxCfg(**SMALL))
    ttok = checkpoint.load_cosmos_dv_pth(*paths, cfg=TorchCfg(**SMALL), device="cpu")
    video = np.random.default_rng(8).integers(0, 256, (1, 16, 64, 64, 3)).astype(np.uint8)
    tokens = ttok.forward(video)
    np.testing.assert_array_equal(tokens, np.asarray(jtok.forward(video)))
    ref = np.asarray(jtok.decode(jnp.asarray(tokens)))
    got = ttok.decode(tokens).numpy()
    assert got.shape == ref.shape == (1, 17, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=LATENT_ATOL, rtol=0)
    diff = np.abs(jax_tensor2numpy(got).astype(int) - jax_tensor2numpy(ref).astype(int))
    assert diff.max() <= UINT8_LEVELS


def test_cosmos_encoder_alone_raises(cosmos_files, tmp_path):
    """An encoder.jit without its decoder leaves the decoder's weights out."""
    with pytest.raises(KeyError, match="missing"):
        checkpoint.load_cosmos_dv_pth(str(cosmos_files / "encoder.jit"), cfg=TorchCfg(**SMALL),
                                      device="cpu")
    shutil.copy(cosmos_files / "cosmos.pth", tmp_path / "c.pth")
    sd = torch.load(tmp_path / "c.pth")
    sd["decoder.conv_in.0.conv3d.weight"] = sd["decoder.conv_in.0.conv3d.weight"][:1]
    torch.save(sd, tmp_path / "c.pth")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_cosmos_dv_pth(str(tmp_path / "c.pth"), cfg=TorchCfg(**SMALL), device="cpu")
