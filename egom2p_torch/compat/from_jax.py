"""JAX package parameters -> the port's state dicts.

The JAX package (egom2p_tpu) holds parameters as a nested dict of arrays
(flax variables).  These converters walk that tree, derive each torch key
with the same naming rules as egom2p_tpu/compat/torch_convert.py (the reverse
direction), and check the result against the target module: every key must
exist with the right shape, and none may be left over.

  flax Dense kernel (in, out)             -> torch Linear weight (out, in)
  flax Conv kernel (kt, kh, kw, in, out)  -> torch Conv3d weight (out, in, kt, kh, kw)
  CausalNormalize scale / bias            -> <module>.norm.weight / .bias
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.array(v, dtype=np.float32)  # a writable copy
    return out


def _params(variables: Mapping) -> Mapping:
    return variables["params"] if "params" in variables else variables


def _checked(sd: Dict[str, np.ndarray], module: nn.Module,
             not_ported: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """Match `sd` against `module.state_dict()`: shapes equal, no key
    missing, none left over (apart from prefixes in `not_ported`)."""
    expected = module.state_dict()
    extra = [k for k in sd if k not in expected
             and not any(k.startswith(p) for p in not_ported)]
    missing = [k for k in expected if k not in sd]
    if extra or missing:
        raise KeyError(f"JAX -> torch key mismatch: left over {extra[:8]}"
                       f"{' ...' if len(extra) > 8 else ''}, missing {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    out = {}
    for key, ref in expected.items():
        arr = sd[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX gives {tuple(arr.shape)}, "
                             f"the port expects {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


# ----------------------------------------------------------------- EgoM2P
def egom2p_state_dict_from_jax(variables: Mapping, model) -> Dict[str, torch.Tensor]:
    """Flax EgoM2P variables -> state dict for `model` (egom2p_torch EgoM2P)."""
    in_domains, out_domains = set(model.in_domains), set(model.out_domains)
    sd: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(_params(variables)).items():
        p0, leaf = path[0], path[-1]
        if p0.startswith("mod_emb_"):  # shared encoder <-> decoder
            mod = p0[len("mod_emb_"):]
            if mod in in_domains:
                sd[f"encoder_embeddings.{mod}.mod_emb"] = arr
            if mod in out_domains:
                sd[f"decoder_embeddings.{mod}.mod_emb"] = arr
        elif p0 == "mask_token":
            sd[p0] = arr
        elif re.fullmatch(r"(en|de)coder_embeddings_.+", p0) and path[1:] == ("token_emb",):
            side, mod = p0.split("_embeddings_", 1)
            sd[f"{side}_embeddings.{mod}.token_emb.weight"] = arr
        elif p0 in ("encoder_norm", "decoder_norm", "decoder_proj_context") or \
                re.fullmatch(r"(encoder|decoder)_\d+", p0):
            block = re.fullmatch(r"(encoder|decoder)_(\d+)", p0)
            base = ".".join([f"{block[1]}.{block[2]}" if block else p0, *path[1:-1]])
            if leaf == "kernel":  # Dense (in, out) -> Linear (out, in)
                sd[f"{base}.weight"] = arr.T
            else:  # Dense bias, LayerNorm weight / bias
                sd[f"{base}.{leaf}"] = arr
        else:
            raise KeyError(f"no torch key for JAX param {'/'.join(path)}")
    return _checked(sd, model)


# ----------------------------------------------------------------- Cosmos
_ATTN_SLOT = {"_s": "0", "_t": "1"}


def _cosmos_torch_key(path: Tuple[str, ...]) -> str:
    """Flax module path inside the tokenizer -> reference torch key prefix
    (the rules of egom2p_tpu/compat/torch_convert.py:_cosmos_torch_key)."""
    out = []
    for p in path:
        m = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)(_[st])?", p)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}.{m.group(3)}.{m.group(4)}")
            if m.group(5):
                out.append(_ATTN_SLOT[m.group(5)])
            continue
        m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", p)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}.{m.group(3)}")
            continue
        m = re.fullmatch(r"mid_attn_1(_[st])?", p)
        if m:
            out.append("mid.attn_1")
            if m.group(1):
                out.append(_ATTN_SLOT[m.group(1)])
            continue
        m = re.fullmatch(r"mid_(block_\d+)", p)
        if m:
            out.append(f"mid.{m.group(1)}")
            continue
        m = re.fullmatch(r"(conv_in|conv_out|conv1|conv2)_(\d)", p)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}")
            continue
        out.append(p)
    return ".".join(out)


# The port holds the encode half; the JAX tokenizer's decoder side is dropped.
COSMOS_NOT_PORTED = ("decoder.", "post_quant_conv.")


def cosmos_state_dict_from_jax(variables: Mapping, net) -> Dict[str, torch.Tensor]:
    """Flax CausalDiscreteVideoTokenizer variables -> state dict for `net`
    (egom2p_torch CausalDiscreteVideoTokenizer)."""
    sd: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(_params(variables)).items():
        base, leaf = _cosmos_torch_key(path[:-1]), path[-1]
        if leaf == "kernel":  # (kt, kh, kw, in, out) -> (out, in, kt, kh, kw)
            sd[f"{base}.weight"] = arr.transpose(4, 3, 0, 1, 2)
        elif leaf == "bias" and path[-2] == "conv3d":
            sd[f"{base}.bias"] = arr
        elif leaf in ("scale", "bias"):  # CausalNormalize -> its GroupNorm
            sd[f"{base}.norm.{'weight' if leaf == 'scale' else 'bias'}"] = arr
        else:
            raise KeyError(f"no torch key for JAX param {'/'.join(path)}")
    return _checked(sd, net, not_ported=COSMOS_NOT_PORTED)
