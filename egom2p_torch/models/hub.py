"""HF-hub-style `FM` wrapper: one-call model + weight loading.

Port of egom2p_tpu/models/hub.py (reference: the `FM(EgoM2P,
PyTorchModelHubMixin)` wrapper, egom2p/models/egom2p_model.py:826-880): the
model is rebuilt from a `config.json`-style dict and its weights read from
a local directory, a bare `.pth`, or a hub id found in the local Hugging
Face cache (`HF_HOME/hub/models--org--name/snapshots/<refs/main>`).
Nothing is downloaded.

Weights in a checkpoint directory: `model.safetensors` (read by
core/safetensors.py, no package), `pytorch_model.bin` or a `*.pth` (the
reference's torch state dicts, whose keys the port's modules carry).  The
JAX package also restores its own trainer's orbax directories; that format
needs orbax, and here it raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import torch

from egom2p_torch.core.device import resolve_device

_CONFIG_KEYS = (
    "dim", "encoder_depth", "decoder_depth", "num_heads", "mlp_ratio",
    "qkv_bias", "proj_bias", "mlp_bias", "norm_bias", "gated_mlp", "qk_norm",
    "decoder_causal_mask", "decoder_sep_mask", "num_register_tokens",
    "share_modality_embeddings", "use_act_checkpoint", "remat_policy",
    "compute_dtype",
)


def _model_from_config(config: Dict):
    """config dict (reference layout: domains_in / domains_out + the
    architecture's fields) -> EgoM2P module (on the CPU)."""
    from egom2p_torch.data.modality_info import MODALITY_INFO
    from egom2p_torch.models.egom2p import EgoM2P, EgoM2PConfig

    kw = {k: config[k] for k in _CONFIG_KEYS if k in config}
    act = config.get("act_layer", config.get("act"))
    if act:
        kw["act"] = {"GELU": "gelu", "SiLU": "silu"}.get(act, str(act).lower())
    info = config.get("modality_info") or MODALITY_INFO
    return EgoM2P(EgoM2PConfig(**kw), in_domains=tuple(config["domains_in"]),
                  out_domains=tuple(config["domains_out"]), modality_info=info)


def model_config(model) -> Dict:
    """The config.json dict `_model_from_config` rebuilds `model` from
    (with the model's own modality info where it is not the default)."""
    from egom2p_torch.data.modality_info import MODALITY_INFO

    cfg = dataclasses.asdict(model.config)
    out = {**{k: cfg[k] for k in _CONFIG_KEYS}, "act": cfg["act"],
           "domains_in": list(model.in_domains), "domains_out": list(model.out_domains)}
    if model.mod_info is not MODALITY_INFO:
        mods = set(model.in_domains) | set(model.out_domains)
        out["modality_info"] = {m: model.mod_info[m] for m in sorted(mods)}
    return out


def _state_dict(fp: str) -> Dict[str, torch.Tensor]:
    if fp.endswith(".safetensors"):
        from egom2p_torch.core.safetensors import read_safetensors
        return {k: torch.from_numpy(v) for k, v in read_safetensors(fp).items()}
    from egom2p_torch.core.checkpoint import load_pth
    sd = load_pth(fp)
    return sd.get("model", sd)


class FM:
    """An EgoM2P module with its weights.  `FM.from_pretrained(path_or_id)`
    mirrors the reference wrapper's entry point; the instance is callable
    like the model (egom2p_tpu FM binds its params the same way)."""

    def __init__(self, model):
        self.model = model

    def __call__(self, mod_dict, num_encoder_tokens: int, num_decoder_tokens: int,
                 *args, **kwargs):
        return self.model(mod_dict, num_encoder_tokens, num_decoder_tokens, *args, **kwargs)

    # ------------------------------------------------------------- loading
    @classmethod
    def from_pretrained(cls, path_or_id: str, config: Optional[Dict] = None,
                        device="cuda") -> "FM":
        """The model of a checkpoint directory (config.json, or `config`,
        plus weights), of a bare .pth with its pickled args, or of a hub id
        in the local cache, on `device` in eval mode."""
        from egom2p_torch.core.checkpoint import copy_state_dict

        device = resolve_device(device)
        path = cls._resolve_local(path_or_id)
        if path is None:
            raise RuntimeError(
                f"{path_or_id!r} is not a local path nor in the local Hugging Face cache, and "
                "nothing is downloaded. Download the checkpoint elsewhere and pass its local "
                "directory (config.json + model.safetensors / pytorch_model.bin / *.pth).")
        if os.path.isfile(path):  # bare .pth: the args namespace is pickled inside
            model = cls._from_pth(path, config)
        else:
            if config is None:
                cfg_file = os.path.join(path, "config.json")
                if not os.path.exists(cfg_file):
                    raise FileNotFoundError(f"no config.json under {path}")
                with open(cfg_file) as f:
                    config = json.load(f)
            model = _model_from_config(config)
            names = ["model.safetensors", "pytorch_model.bin"] + sorted(
                f for f in os.listdir(path) if f.endswith(".pth"))
            found = [n for n in names if os.path.exists(os.path.join(path, n))]
            if not found:
                raise ValueError(
                    f"{path} holds no model.safetensors, pytorch_model.bin or .pth: the JAX "
                    "trainer's orbax checkpoint directories need orbax and are not read here")
            fp = os.path.join(path, found[0])
            copy_state_dict(model, _state_dict(fp), f"EgoM2P weights {fp}",
                            ignore=lambda key: key.endswith(".pos_emb"))
        return cls(model.to(device).eval())

    @staticmethod
    def _resolve_local(path_or_id: str) -> Optional[str]:
        if os.path.exists(path_or_id):
            return path_or_id
        # HF_HOME-style local cache: hub/models--org--name/snapshots/<rev>
        cache = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
        slug = "models--" + path_or_id.replace("/", "--")
        snap_root = os.path.join(cache, "hub", slug, "snapshots")
        if os.path.isdir(snap_root):
            # refs/main names the current revision; hash sort order is
            # meaningless when several snapshots exist
            ref = os.path.join(cache, "hub", slug, "refs", "main")
            if os.path.isfile(ref):
                with open(ref) as f:
                    rev = f.read().strip()
                cand = os.path.join(snap_root, rev)
                if os.path.isdir(cand):
                    return cand
            snaps = sorted(os.listdir(snap_root))
            if snaps:
                return os.path.join(snap_root, snaps[-1])
        return None

    @staticmethod
    def _from_pth(path: str, config: Optional[Dict]):
        from egom2p_torch.core.checkpoint import load_egom2p_pth, load_pth
        from egom2p_torch.models.egom2p import create_model

        ckpt = load_pth(path)
        if config is None:
            args = ckpt.get("args")
            if args is None:
                raise ValueError(f"{path} has no pickled args; pass config=")
            model = create_model(args.model, in_domains=sorted(args.in_domains),
                                 out_domains=sorted(args.out_domains))
        else:
            model = _model_from_config(config)
        return load_egom2p_pth(path, model, ckpt)

    # -------------------------------------------------------------- saving
    def save_pretrained(self, directory: str, weights: str = "model.safetensors") -> str:
        """config.json and the weights (`weights`: model.safetensors,
        pytorch_model.bin or NAME.pth) in `directory`, which from_pretrained
        reads back.  Returns the weights' path."""
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(model_config(self.model), f, indent=1)
        fp = os.path.join(directory, weights)
        sd = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        if weights.endswith(".safetensors"):
            from egom2p_torch.core.safetensors import write_safetensors
            write_safetensors(fp, sd)
        elif weights.endswith((".bin", ".pth")):
            torch.save({"model": sd}, fp)
        else:
            raise ValueError(f"weights {weights!r}: .safetensors, .bin or .pth")
        return fp
