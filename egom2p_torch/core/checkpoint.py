"""Checkpoints in the reference's .pth format: save, find the latest, resume,
warm start, and the loaders of released EgoM2P and Cosmos weights.

Port of egom2p_tpu/core/checkpoint.py (reference:
egom2p/utils/checkpoint.py:91-157) and of the .pth readers of
egom2p_tpu/compat/torch_convert.py:161-275, 334-366, 504-541 (EgoM2P, the
cam and gaze VQ-VAEs, the Cosmos video and image tokenizers).  A training checkpoint
is `<output_dir>/checkpoint-{tag}.pth` holding
{"model", "optimizer", "step", "epoch", "args": argparse.Namespace}, as the
reference pickles it, so the JAX package's readers rebuild the same model
from it.  The port's module names are the reference's torch keys: loading
EgoM2P weights is a key-checked copy.

On a model that core/fsdp.py sharded, a save gathers the full weights and
Adam moments on every rank (a collective: every rank calls save_checkpoint,
and only the one given write=True writes), and a load keeps each rank's
pieces of the full tensors, so one file serves FSDP at any world size,
data parallelism and one process.

Files are read with torch.load(weights_only=True) and argparse.Namespace
allowed as the one class beyond tensors and plain containers: a file that
pickles anything else raises instead of running its code.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from egom2p_torch.core import fsdp
from egom2p_torch.tokenizers.cosmos.network import CausalDiscreteVideoTokenizer, DV4x8x8_CONFIG
from egom2p_torch.tokenizers.cosmos.video_api import CausalVideoTokenizer
from egom2p_torch.tokenizers.seq_vqvae import SeqTokenizer, seq_vqvae_from_config


def checkpoint_path(output_dir: str, tag) -> str:
    return os.path.join(os.path.abspath(output_dir), f"checkpoint-{tag}.pth")


def load_pth(path: str) -> Dict:
    """A .pth file on the CPU, with a pickled argparse.Namespace allowed."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def _to_host(obj, memo: Dict):
    """`obj` with every tensor copied to host memory; tensors that share a
    storage share its copy, so the file holds the storages torch.save
    would write for the originals."""
    if isinstance(obj, torch.Tensor):
        storage = obj.untyped_storage()
        key = (obj.device, storage.data_ptr())
        if key not in memo:
            memo[key] = storage.cpu() if obj.device.type != "cpu" else storage.clone()
        return torch.empty(0, dtype=obj.dtype).set_(memo[key], obj.storage_offset(),
                                                    obj.size(), obj.stride())
    if isinstance(obj, dict):
        return type(obj)((k, _to_host(v, memo)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, memo) for v in obj)
    return obj


def _write(state: Dict, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


# the one save in flight: a second save, or wait_for_saves, joins it first
_SAVE_THREAD: Optional[threading.Thread] = None
_SAVE_ERROR: list = []


def save_in_flight() -> Optional[threading.Thread]:
    """The thread writing the save in flight (blocking=False), or None."""
    return _SAVE_THREAD


def wait_for_saves() -> None:
    """Block until the save in flight (blocking=False) is on disk; raises
    what its write raised."""
    global _SAVE_THREAD
    if _SAVE_THREAD is not None:
        _SAVE_THREAD.join()
        _SAVE_THREAD = None
    if _SAVE_ERROR:
        raise _SAVE_ERROR.pop()


def save_checkpoint(output_dir: str, tag, model: nn.Module, optimizer=None, step: int = 0,
                    epoch: int = -1, args=None, blocking: bool = True, write: bool = True,
                    **extra) -> str:
    """Write checkpoint-{tag}.pth (to a temporary name, then renamed into
    place: an interrupted save leaves the previous file whole).  `args` is
    stored as an argparse.Namespace.  The model's and the optimizer's
    state is copied to host memory before it returns; with blocking=False
    the file is written on a background thread (the next steps cannot
    change what it holds): wait_for_saves() before relying on the file
    (egom2p_tpu/core/checkpoint.py:36-61).  With write=False nothing is
    written: the call only takes part in a sharded model's gathers (the
    module docstring).  Returns the file's path."""
    global _SAVE_THREAD
    if isinstance(args, dict):
        args = argparse.Namespace(**args)
    state = {"model": fsdp.full_state_dict(model), "step": int(step), "epoch": int(epoch),
             "args": args, **extra}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    path = checkpoint_path(output_dir, tag)
    if not write:
        return path
    state = _to_host(state, {})
    wait_for_saves()
    if blocking:
        _write(state, path)
        return path

    def write():
        try:
            _write(state, path)
        except BaseException as e:  # raised again by wait_for_saves
            _SAVE_ERROR.append(e)

    _SAVE_THREAD = threading.Thread(target=write, name=f"save {os.path.basename(path)}")
    _SAVE_THREAD.start()
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The checkpoint-{N}.pth with the largest N, else checkpoint-final.pth
    (reference: checkpoint.py:126-136)."""
    best, best_n = None, -1
    for c in glob.glob(checkpoint_path(output_dir, "*")):
        m = re.search(r"checkpoint-(\d+)\.pth$", c)
        if m and int(m.group(1)) > best_n:
            best, best_n = c, int(m.group(1))
    final = checkpoint_path(output_dir, "final")
    if best is None and os.path.isfile(final):
        best = final
    return best


def auto_load_model(output_dir: str, model: nn.Module,
                    optimizer=None) -> Tuple[Optional[Dict], Optional[str]]:
    """Resume from the latest checkpoint under `output_dir` (reference:
    checkpoint.py:123-157): the model's weights (strict) and, when given,
    the optimizer's state (each rank's pieces on a sharded model).  Returns
    (checkpoint, path) or (None, None)."""
    path = latest_checkpoint(output_dir)
    if path is None:
        return None, None
    ckpt = load_pth(path)
    fsdp.load_full_state_dict(model, ckpt["model"])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    return ckpt, path


def read_pth_args(path: str):
    """The argparse namespace the reference pickles inside a checkpoint
    (reference: checkpoint.py:100-105), or None."""
    return load_pth(path).get("args")


def copy_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor], what: str,
                    ignore=lambda key: False) -> None:
    """Copy `sd` into `module`, cast to the module's dtypes: every key the
    module holds must be there with its shape, and no other key may be left
    over apart from those `ignore` accepts."""
    expected = module.state_dict()
    missing = [k for k in expected if k not in sd]
    extra = [k for k in sd if k not in expected and not ignore(k)]
    if missing or extra:
        raise KeyError(f"{what}: missing {missing[:8]}{' ...' if len(missing) > 8 else ''}, "
                       f"left over {extra[:8]}{' ...' if len(extra) > 8 else ''}")
    bad = [f"{k}: file {tuple(sd[k].shape)}, model {tuple(v.shape)}"
           for k, v in expected.items() if tuple(sd[k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"{what}: shape mismatch: " + "; ".join(bad[:8]))
    module.load_state_dict({k: sd[k].to(v.dtype) for k, v in expected.items()})


def load_egom2p_pth(path: str, model: nn.Module, ckpt: Optional[Dict] = None) -> nn.Module:
    """Load a reference EgoM2P checkpoint ({"model": state_dict, ...} or a
    bare state dict) into `model`; `ckpt` is the file's contents where the
    caller has read them already.  The reference's persistent `pos_emb`
    buffers are skipped (the port computes its sincos tables, as the JAX
    converter does)."""
    ckpt = load_pth(path) if ckpt is None else ckpt
    copy_state_dict(model, ckpt.get("model", ckpt), f"EgoM2P weights {path}",
                    ignore=lambda key: key.endswith(".pos_emb"))
    return model


def warm_start(model: nn.Module, path: str) -> Tuple[int, int]:
    """Non-strict warm start: copy the tensors of a checkpoint whose key and
    shape match the model's; the rest keep their init (reference:
    run_training_egom2p.py:477-489; the reference's pos_emb buffers are not
    in the port's state dict; a sharded model keeps its pieces).  Returns
    (copied, total)."""
    ckpt = load_pth(path)
    sd = ckpt.get("model", ckpt)
    own, shapes = model.state_dict(), fsdp.full_shapes(model)
    take = {k: sd[k].to(v.dtype) for k, v in own.items()
            if k in sd and tuple(sd[k].shape) == shapes[k]}
    fsdp.load_full_state_dict(model, take, strict=False)
    print(f"warm start: copied {len(take)}/{len(own)} tensors from {path}")
    return len(take), len(own)


def _cosmos_sd(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".jit"):
        return dict(torch.jit.load(path, map_location="cpu").state_dict())
    ckpt = load_pth(path)
    return dict(ckpt.get("model", ckpt))


def load_cosmos_dv_pth(encoder_path: str, decoder_path: Optional[str] = None, cfg=None,
                       device="cuda"):
    """Cosmos DV weights from a TorchScript encoder.jit / decoder.jit pair or
    a .pth of the whole network's state dict -> CausalVideoTokenizer on
    `device` (the card by default: core/device.py).  The JIT files'
    quantizer buffers (`quantizer.*`, `inv_quant.*`) are dropped: FSQ holds
    no weights."""
    from egom2p_torch.core.device import resolve_device

    device = resolve_device(device)
    sd = _cosmos_sd(encoder_path)
    if decoder_path:
        sd.update(_cosmos_sd(decoder_path))
    sd = {k: v for k, v in sd.items()
          if not k.startswith("inv_quant") and not k.startswith("quantizer")}
    net = CausalDiscreteVideoTokenizer(cfg or DV4x8x8_CONFIG)
    copy_state_dict(net, sd, f"Cosmos weights {encoder_path}"
                             + (f" + {decoder_path}" if decoder_path else ""))
    return CausalVideoTokenizer(net.to(device))


def load_cosmos_image_pth(encoder_path: str, decoder_path: Optional[str] = None, cfg=None,
                          discrete: bool = True, device="cuda"):
    """Cosmos CI / DI weights from a TorchScript encoder.jit / decoder.jit
    pair or a .pth of the whole network's state dict -> ImageTokenizer on
    `device`, the card by default (egom2p_tpu/compat/torch_convert.py:load_cosmos_image_pth;
    reference: cosmos_tokenizer/utils.py load_model / load_encoder_model).
    The quantizer's derived buffers (`inv_quant.*`, `quantizer.*` but a VQ
    codebook's `quantizer.embedding.weight`) and `distribution.*` are
    dropped; every other key is checked against the network at `cfg` (DI
    or CI by default)."""
    from egom2p_torch.tokenizers.cosmos.image_api import ImageTokenizer
    from egom2p_torch.tokenizers.cosmos.image_network import (CI_CONFIG, DI_CONFIG,
                                                              ContinuousImageTokenizer,
                                                              DiscreteImageTokenizer)
    from egom2p_torch.core.device import resolve_device

    device = resolve_device(device)
    sd = _cosmos_sd(encoder_path)
    if decoder_path:
        sd.update(_cosmos_sd(decoder_path))
    sd = {k: v for k, v in sd.items() if not k.startswith(("inv_quant", "distribution"))
          and not (k.startswith("quantizer") and "embedding" not in k)}
    cfg = cfg or (DI_CONFIG if discrete else CI_CONFIG)
    net = (DiscreteImageTokenizer if discrete else ContinuousImageTokenizer)(cfg)
    copy_state_dict(net, sd, f"Cosmos image weights {encoder_path}"
                             + (f" + {decoder_path}" if decoder_path else ""))
    return ImageTokenizer(net.to(device))


class _EncoderJit(nn.Module):
    """The key layout of Cosmos's encoder.jit: encoder, quant_conv and the
    quantizer (a VQ codebook, or the FSQ levels as a buffer)."""

    def __init__(self, net):
        super().__init__()
        self.encoder, self.quant_conv = net.encoder, net.quant_conv
        if isinstance(getattr(net, "quantizer", None), nn.Module):
            self.quantizer = net.quantizer
        elif hasattr(net, "quantizer"):
            self.quantizer = nn.Module()
            self.quantizer.register_buffer("_levels", torch.tensor(net.cfg.levels))

    def forward(self, x):
        return self.quant_conv(self.encoder(x))


class _DecoderJit(nn.Module):
    """The key layout of Cosmos's decoder.jit: post_quant_conv, decoder and
    the inverse quantizer's buffers."""

    def __init__(self, net):
        super().__init__()
        self.post_quant_conv, self.decoder = net.post_quant_conv, net.decoder
        if hasattr(net, "quantizer"):
            self.inv_quant = nn.Module()
            self.inv_quant.quantizer = nn.Module()
            self.inv_quant.quantizer.register_buffer("_levels", torch.tensor(net.cfg.levels))

    def forward(self, z):
        return self.decoder(self.post_quant_conv(z))


def save_cosmos_image_jit(net, directory: str, size: int = 64) -> Tuple[str, str]:
    """A Cosmos image network (image_network.py) as TorchScript
    `encoder.jit` / `decoder.jit` files in `directory`, in the key layout of
    the released files (traced on a `size`^2 image).  Returns the paths."""
    import warnings

    os.makedirs(directory, exist_ok=True)
    dev = next(net.parameters()).device
    grid = size // net.cfg.spatial_compression
    with warnings.catch_warnings(), torch.no_grad():
        warnings.simplefilter("ignore")  # the tracer's notes on shape-dependent branches
        enc = torch.jit.trace(_EncoderJit(net), torch.zeros(1, size, size, 3, device=dev))
        dec = torch.jit.trace(_DecoderJit(net), torch.zeros(
            1, net.post_quant_conv.in_channels, grid, grid, device=dev))
    paths = os.path.join(directory, "encoder.jit"), os.path.join(directory, "decoder.jit")
    enc.save(paths[0])
    dec.save(paths[1])
    return paths


def load_seq_vqvae_pth(path: str, domain: str, device="cuda", **config) -> SeqTokenizer:
    """A reference cam or gaze VQ-VAE checkpoint ({"model": state_dict} or a
    bare state dict, with the codebook's `quantize._codebook.{embed,
    cluster_size,initted}` buffers) -> SeqTokenizer on `device`.  `config`
    overrides the released widths (seq_vqvae_from_config); every key of the
    file is checked against them.  Keys ending in `pos_emb` (fixed sincos
    tables, which the port computes) are skipped, as in load_egom2p_pth."""
    from egom2p_torch.core.device import resolve_device
    device = resolve_device(device)
    tok = load_vqvae_pth(path, seq_vqvae_from_config(domain, **config), f"{domain} tokenizer")
    tok.net.to(device)
    return tok


def save_seq_vqvae_pth(tokenizer: SeqTokenizer, path: str) -> str:
    """A cam or gaze tokenizer in the reference's layout: {"model":
    state_dict} with the codebook buffers."""
    torch.save({"model": {k: v.cpu() for k, v in tokenizer.net.state_dict().items()}}, path)
    return path


# (the reference's DiVAE key, the port's key, what each block copies)
_DIVAE_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
                     "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
                     "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")


@torch.no_grad()
def load_divae_encoder_warm_start(safetensors_path: str, net: nn.Module,
                                  verbose: bool = True) -> Tuple[list, list]:
    """Warm-start a video VQ-VAE's encoder (tokenizers/video_vqvae.py's
    VideoAutoencoder) from 4M DiVAE rgb-tokenizer weights in a local
    .safetensors file (reference: egom2p/vq/vqvae.py:501-554,
    --init_weights; egom2p_tpu/compat/torch_convert.py:
    load_divae_encoder_warm_start):

      * the 2-D patch projection `encoder.proj` fills the CENTRAL frame of
        the tubelet projection (the other frames keep their init);
      * each encoder block copies norm1 / attn.qkv / attn.proj / norm2 /
        mlp.fc1 / mlp.fc2 where the file has them;
      * quant_proj takes the 1x1 conv's (or a linear's) weight and bias.

    The file's keys with no target here (the 2-D encoder's norm_mlp /
    post_mlp) are skipped and reported.  Returns (copied, skipped) keys.
    (The JAX package's version asks its LayerNorms for a `scale` they name
    `weight`, so it leaves the blocks' norm weights at their init; this one
    copies them, as the reference does.)"""
    from egom2p_torch.core.safetensors import read_safetensors

    sd = read_safetensors(safetensors_path)
    own = dict(net.named_parameters())
    copied, skipped = [], []

    def put(key: str, value) -> None:
        dst = own[key]
        value = torch.as_tensor(np.asarray(value, dtype=np.float32))
        if tuple(dst.shape) != tuple(value.shape):
            raise ValueError(f"DiVAE warm start: {key} is {tuple(dst.shape)}, "
                             f"the file gives {tuple(value.shape)}")
        dst.copy_(value)
        copied.append(key)

    if "encoder.proj.weight" in sd:
        w = own["encoder.patch_embed.weight"]          # (D, C, t, p, p)
        w[:, :, w.shape[2] // 2] = torch.as_tensor(sd["encoder.proj.weight"]).to(w)
        copied.append("encoder.patch_embed.weight")
        if "encoder.proj.bias" in sd:
            put("encoder.patch_embed.bias", sd["encoder.proj.bias"])
    for i in range(len(net.encoder.blocks)):
        for name in _DIVAE_BLOCK_KEYS:
            key = f"encoder.blocks.{i}.{name}"
            (put(key, sd[key]) if key in sd else skipped.append(key))
    if "quant_proj.weight" in sd:
        w = sd["quant_proj.weight"]
        put("quant_proj.weight", w.reshape(w.shape[0], -1))
        if "quant_proj.bias" in sd:
            put("quant_proj.bias", sd["quant_proj.bias"])
    used = set(copied) | {"encoder.proj.weight", "encoder.proj.bias"}
    skipped += sorted(k for k in sd if k not in used)
    if verbose:
        print(f"DiVAE warm start: copied {len(copied)} tensors, skipped {len(skipped)} keys "
              "without a source or a target")
    return copied, skipped


def load_vqvae_pth(path: str, tokenizer, what: str):
    """A trainer checkpoint or a reference .pth ({"model": state_dict}, or a
    bare state dict) of a VQ-VAE into `tokenizer.net` (any tokenizer of
    tokenizers/*_vqvae.py, built at the checkpoint's widths), every key
    checked; keys ending in `pos_emb` (fixed sincos tables, which the port
    computes) are skipped, as in load_egom2p_pth.  Returns the tokenizer."""
    ckpt = load_pth(path)
    sd = dict(ckpt.get("model", ckpt))
    initted = "quantize._codebook.initted"
    if initted in sd and sd[initted].numel() == 1:  # a flag in any one-element form
        sd[initted] = sd[initted].reshape(1)
    copy_state_dict(tokenizer.net, sd, f"{what} weights {path}",
                    ignore=lambda key: key.endswith("pos_emb"))
    return tokenizer
