"""Checkpoints in the reference's .pth format: save, find the latest, resume,
warm start, and the loaders of released EgoM2P and Cosmos weights.

Port of egom2p_tpu/core/checkpoint.py (reference:
egom2p/utils/checkpoint.py:91-157) and of the .pth readers of
egom2p_tpu/compat/torch_convert.py:161-275, 334-366 (EgoM2P, the cam and
gaze VQ-VAEs, Cosmos).  A training checkpoint
is `<output_dir>/checkpoint-{tag}.pth` holding
{"model", "optimizer", "step", "epoch", "args": argparse.Namespace}, as the
reference pickles it, so the JAX package's readers rebuild the same model
from it.  The port's module names are the reference's torch keys: loading
EgoM2P weights is a key-checked copy.

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

import torch
from torch import nn

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
                    epoch: int = -1, args=None, blocking: bool = True, **extra) -> str:
    """Write checkpoint-{tag}.pth (to a temporary name, then renamed into
    place: an interrupted save leaves the previous file whole).  `args` is
    stored as an argparse.Namespace.  The model's and the optimizer's
    state is copied to host memory before it returns; with blocking=False
    the file is written on a background thread (the next steps cannot
    change what it holds): wait_for_saves() before relying on the file
    (egom2p_tpu/core/checkpoint.py:36-61)."""
    global _SAVE_THREAD
    if isinstance(args, dict):
        args = argparse.Namespace(**args)
    state = {"model": model.state_dict(), "step": int(step), "epoch": int(epoch), "args": args,
             **extra}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    state = _to_host(state, {})
    path = checkpoint_path(output_dir, tag)
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
    the optimizer's state.  Returns (checkpoint, path) or (None, None)."""
    path = latest_checkpoint(output_dir)
    if path is None:
        return None, None
    ckpt = load_pth(path)
    model.load_state_dict(ckpt["model"])
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
    in the port's state dict).  Returns (copied, total)."""
    ckpt = load_pth(path)
    sd = ckpt.get("model", ckpt)
    own = model.state_dict()
    take = {k: sd[k].to(v.dtype) for k, v in own.items()
            if k in sd and tuple(sd[k].shape) == tuple(v.shape)}
    model.load_state_dict(take, strict=False)
    print(f"warm start: copied {len(take)}/{len(own)} tensors from {path}")
    return len(take), len(own)


def _cosmos_sd(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".jit"):
        return dict(torch.jit.load(path, map_location="cpu").state_dict())
    ckpt = load_pth(path)
    return dict(ckpt.get("model", ckpt))


def load_cosmos_dv_pth(encoder_path: str, decoder_path: Optional[str] = None, cfg=None,
                       device="cpu"):
    """Cosmos DV weights from a TorchScript encoder.jit / decoder.jit pair or
    a .pth of the whole network's state dict -> CausalVideoTokenizer on
    `device`.  The JIT files' quantizer buffers (`quantizer.*`,
    `inv_quant.*`) are dropped: FSQ holds no weights."""
    sd = _cosmos_sd(encoder_path)
    if decoder_path:
        sd.update(_cosmos_sd(decoder_path))
    sd = {k: v for k, v in sd.items()
          if not k.startswith("inv_quant") and not k.startswith("quantizer")}
    net = CausalDiscreteVideoTokenizer(cfg or DV4x8x8_CONFIG)
    copy_state_dict(net, sd, f"Cosmos weights {encoder_path}"
                             + (f" + {decoder_path}" if decoder_path else ""))
    return CausalVideoTokenizer(net.to(device))


def load_seq_vqvae_pth(path: str, domain: str, device="cpu", **config) -> SeqTokenizer:
    """A reference cam or gaze VQ-VAE checkpoint ({"model": state_dict} or a
    bare state dict, with the codebook's `quantize._codebook.{embed,
    cluster_size,initted}` buffers) -> SeqTokenizer on `device`.  `config`
    overrides the released widths (seq_vqvae_from_config); every key of the
    file is checked against them.  Keys ending in `pos_emb` (fixed sincos
    tables, which the port computes) are skipped, as in load_egom2p_pth."""
    ckpt = load_pth(path)
    sd = dict(ckpt.get("model", ckpt))
    initted = "quantize._codebook.initted"
    if initted in sd and sd[initted].numel() == 1:  # a flag in any one-element form
        sd[initted] = sd[initted].reshape(1)
    tok = seq_vqvae_from_config(domain, **config)
    copy_state_dict(tok.net, sd, f"{domain} tokenizer weights {path}",
                    ignore=lambda key: key.endswith("pos_emb"))
    tok.net.to(device)
    return tok


def save_seq_vqvae_pth(tokenizer: SeqTokenizer, path: str) -> str:
    """A cam or gaze tokenizer in the reference's layout: {"model":
    state_dict} with the codebook buffers."""
    torch.save({"model": {k: v.cpu() for k, v in tokenizer.net.state_dict().items()}}, path)
    return path
