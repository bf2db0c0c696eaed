"""JAX package parameters -> the port's state dicts.

The JAX package (egom2p_tpu) holds parameters as a nested dict of arrays
(flax variables).  These converters walk that tree, derive each torch key
with the same naming rules as egom2p_tpu/compat/torch_convert.py (the reverse
direction), and check the result against the target module: every key must
exist with the right shape, and none may be left over.

  flax Dense kernel (in, out)             -> torch Linear weight (out, in)
  EgoM2P mod_emb_<m> / dec_mod_emb_<m>    -> <en|de>coder_embeddings.<m>.mod_emb
  untied head to_logits (V, D)            -> decoder_embeddings.<m>.to_logits.weight
  LoRA {path: {a (in, r), b (r, out)}}    -> {dotted weight: {a (r, in), b (out, r)}}
  SequenceEmbEncoderEmbedding emb_proj,
    emb_proj_0 / emb_proj_1 (bottleneck)  -> emb_proj, emb_proj.0 / emb_proj.1
  flax Conv kernel (kt, kh, kw, in, out)  -> torch Conv3d weight (out, in, kt, kh, kw)
  flax Conv kernel (k, in, out)           -> torch Conv1d weight (out, in, k)
  flax Conv kernel (kh, kw, in, out)      -> torch Conv2d weight (out, in, kh, kw)
  Cosmos image Normalize2d norm/scale     -> <module>.weight (the GroupNorm itself)
  taming VQ embedding (n, D)              -> quantizer.embedding.weight
  Memcodes codes / to_k / to_v            -> quantizer.codes / to_k / to_v (as they are)
  GradVQAutoencoder core/...              -> core.<the core's own keys>
  seq VQ-VAE quant_proj Dense (in, out)   -> 1x1 Conv1d weight (out, in, 1)
  CausalNormalize scale / bias            -> <module>.norm.weight / .bias
  VQState embed / cluster_size / initted  -> quantize._codebook.<same>
  blocks_<i>                              -> blocks.<i>
  image_raw encoder_embeddings_<m>/proj   -> encoder_embeddings.<m>.proj.weight
  ViTTeacher cls_token / pos_embed / proj,
    LayerScale ls1 / ls2                  -> the same names (proj stays (width, feat))
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

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


def _checked(sd: Dict[str, np.ndarray], module: nn.Module) -> Dict[str, torch.Tensor]:
    """Match `sd` against `module.state_dict()`: shapes equal, no key
    missing, none left over."""
    expected = module.state_dict()
    extra = [k for k in sd if k not in expected]
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
    shared = model.config.share_modality_embeddings
    sd: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(_params(variables)).items():
        p0, leaf = path[0], path[-1]
        if p0.startswith("mod_emb_"):  # encoder's, and the decoder's where shared
            mod = p0[len("mod_emb_"):]
            if mod in in_domains:
                sd[f"encoder_embeddings.{mod}.mod_emb"] = arr
            if mod in out_domains and (shared or mod not in in_domains):
                sd[f"decoder_embeddings.{mod}.mod_emb"] = arr
        elif p0.startswith("dec_mod_emb_"):
            sd[f"decoder_embeddings.{p0[len('dec_mod_emb_'):]}.mod_emb"] = arr
        elif p0 in ("mask_token", "register_tokens"):
            sd[p0] = arr
        elif p0.startswith("decoder_embeddings_") and path[1:] == ("to_logits",):
            sd[f"decoder_embeddings.{p0[len('decoder_embeddings_'):]}.to_logits.weight"] = arr
        elif re.fullmatch(r"(en|de)coder_embeddings_.+", p0) and path[1:] == ("token_emb",):
            side, mod = p0.split("_embeddings_", 1)
            sd[f"{side}_embeddings.{mod}.token_emb.weight"] = arr
        elif p0.startswith("encoder_embeddings_") and path[1:] == ("proj", "kernel"):
            # the raw-pixel patch projection (image_raw)
            sd[f"encoder_embeddings.{p0[len('encoder_embeddings_'):]}.proj.weight"] = arr.T
        elif p0.startswith("encoder_embeddings_") and path[1].startswith("emb_proj"):
            mod = p0[len("encoder_embeddings_"):]
            base = f"encoder_embeddings.{mod}.{path[1].replace('emb_proj_', 'emb_proj.')}"
            sd[f"{base}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                arr.T if leaf == "kernel" else arr)
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


def lora_state_from_jax(lora: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's LoRA adapters ({"params/encoder_0/attn/qkv/kernel":
    {"a": (in, r), "b": (r, out)}}, egom2p_tpu/models/lora.py) -> the port's
    ({"encoder.0.attn.qkv.weight": {"a": (r, in), "b": (out, r)}},
    egom2p_torch/models/lora.py)."""
    out = {}
    for key, ab in lora.items():
        path = [p for p in key.split("/") if p != "params"]
        if path[-1] != "kernel":
            raise KeyError(f"no torch key for the JAX LoRA entry {key}")
        block = re.fullmatch(r"(encoder|decoder)_(\d+)", path[0])
        head = [f"{block[1]}.{block[2]}"] if block else [path[0]]
        name = ".".join(head + path[1:-1] + ["weight"])
        out[name] = {k: torch.from_numpy(np.array(ab[k], dtype=np.float32).T.copy())
                     for k in ("a", "b")}
    return out


# ----------------------------------------------------------------- Cosmos
_ATTN_SLOT = {"_s": "0", "_t": "1"}


def _cosmos_torch_key(path: Tuple[str, ...]) -> str:
    """Flax module path inside the tokenizer -> reference torch key prefix
    (the rules of egom2p_tpu/compat/torch_convert.py:_cosmos_torch_key).
    The BASE network's names (`conv_in`, `conv1`, `nin_shortcut`,
    `down_<i>_downsample/conv`, `up_<i>_upsample/conv`, `mid_attn_1` without
    a slot) pass through these rules unchanged but for the level indices."""
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


def cosmos_state_dict_from_jax(variables: Mapping, net) -> Dict[str, torch.Tensor]:
    """Flax CausalDiscreteVideoTokenizer or CausalContinuousVideoTokenizer
    variables (FACTORIZED or BASE) -> state dict for `net` (its egom2p_torch
    counterpart)."""
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
    return _checked(sd, net)


def _cosmos2d_torch_key(path: Tuple[str, ...]) -> str:
    """Flax module path inside the 2-D image tokenizer -> reference torch
    key prefix (egom2p_tpu/compat/torch_convert.py:_cosmos2d_torch_key):
    Normalize2d's inner GroupNorm scope is dropped."""
    out = []
    for p in path:
        m = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)", p)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}.{m.group(3)}.{m.group(4)}")
            continue
        m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", p)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}.{m.group(3)}")
            continue
        m = re.fullmatch(r"mid_(attn_1|block_\d+)", p)
        if m:
            out.append(f"mid.{m.group(1)}")
            continue
        if p == "norm" and out and out[-1].split(".")[-1].startswith("norm"):
            continue  # "norm1/norm" -> "norm1"
        out.append(p)
    return ".".join(out)


def cosmos_image_state_dict_from_jax(variables: Mapping, net) -> Dict[str, torch.Tensor]:
    """Flax DiscreteImageTokenizer or ContinuousImageTokenizer variables ->
    state dict for `net` (tokenizers/cosmos/image_network.py): conv2d
    (kh, kw, in, out) -> (out, in, kh, kw), GroupNorm scale -> weight, the
    taming codebook -> quantizer.embedding.weight."""
    sd: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(_params(variables)).items():
        base, leaf = _cosmos2d_torch_key(path[:-1]), path[-1]
        if leaf == "kernel":
            sd[f"{base}.weight"] = arr.transpose(3, 2, 0, 1)
        elif leaf in ("scale", "bias"):
            sd[f"{base}.{'weight' if leaf == 'scale' else 'bias'}"] = arr
        elif leaf == "embedding":
            sd[f"{base}.embedding.weight"] = arr
        else:
            raise KeyError(f"no torch key for JAX param {'/'.join(path)}")
    return _checked(sd, net)


# ------------------------------------------------------------- seq VQ-VAE
def _seq_core_sd(params: Mapping) -> Dict[str, np.ndarray]:
    """A flax SeqAutoencoder's parameters -> the port's keys: the rules of
    egom2p_tpu/compat/torch_convert.py:convert_seq_vqvae_state_dict,
    reversed."""
    sd: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(params).items():
        p0, leaf = path[0], path[-1]
        if p0 in ("quant_proj", "post_quant_proj"):
            sd[f"{p0}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
                arr.T[:, :, None] if leaf == "kernel" else arr)
            continue
        if p0 not in ("encoder", "decoder"):
            raise KeyError(f"no torch key for JAX param {'/'.join(path)}")
        rest = [f"blocks.{p[len('blocks_'):]}" if p.startswith("blocks_") else p
                for p in path[1:-1]]
        base = ".".join([p0, *rest])
        if leaf == "kernel" and path[1] == "conv":  # (k, in, out) -> (out, in, k)
            sd[f"{base}.weight"] = arr.transpose(2, 1, 0)
        elif leaf == "kernel":
            sd[f"{base}.weight"] = arr.T
        else:  # Dense / Conv bias, LayerNorm weight / bias
            sd[f"{base}.{leaf}"] = arr
    return sd


def _codebook_sd(vq_state, net) -> Dict[str, np.ndarray]:
    """A VQState's arrays as the port's `quantize._codebook` buffers."""
    return {f"quantize._codebook.{name}": np.array(
        getattr(vq_state, name), dtype=np.float32).reshape(
            net.quantize._codebook.get_buffer(name).shape)
        for name in ("embed", "cluster_size", "initted")}


def seq_vqvae_state_dict_from_jax(variables: Mapping, vq_state,
                                  tokenizer) -> Dict[str, torch.Tensor]:
    """Flax SeqAutoencoder variables and a VQState (any arrays numpy can
    read) -> state dict for `tokenizer.net` (egom2p_torch SeqTokenizer)."""
    return _checked({**_seq_core_sd(_params(variables)), **_codebook_sd(vq_state, tokenizer.net)},
                    tokenizer.net)


# ---------------------------------------------- video / feature VQ-VAEs
def _dotted(path: Tuple[str, ...]) -> str:
    return ".".join(f"blocks.{p[len('blocks_'):]}" if p.startswith("blocks_") else p
                    for p in path)


def _kernel(arr: np.ndarray) -> np.ndarray:
    """A flax Dense / Conv kernel in torch's layout."""
    if arr.ndim == 2:  # (in, out) -> (out, in)
        return arr.T
    return arr.transpose(arr.ndim - 1, arr.ndim - 2, *range(arr.ndim - 2))  # (..., in, out)


def _vit_core_sd(params: Mapping) -> Dict[str, np.ndarray]:
    """A flax VideoAutoencoder's or FeatureAutoencoder's parameters -> the
    port's keys: the tubelet Conv kernel (t, p, p, C, D) -> (D, C, t, p,
    p), Dense kernels transposed, blocks_<i> -> blocks.<i>."""
    sd: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(params).items():
        base, leaf = _dotted(path[:-1]), path[-1]
        sd[f"{base}.{'weight' if leaf == 'kernel' else leaf}"] = (
            _kernel(arr) if leaf == "kernel" else arr)
    return sd


def video_vqvae_state_dict_from_jax(variables: Mapping, vq_state, tokenizer
                                    ) -> Dict[str, torch.Tensor]:
    """Flax VideoAutoencoder (or FeatureAutoencoder) variables and a VQState
    -> state dict for `tokenizer.net` (egom2p_torch VideoVQTokenizer /
    FeatureVQTokenizer)."""
    return _checked({**_vit_core_sd(_params(variables)), **_codebook_sd(vq_state, tokenizer.net)},
                    tokenizer.net)


# the feature VQ-VAE's tree follows the same rules
feature_vqvae_state_dict_from_jax = video_vqvae_state_dict_from_jax


def grad_vqvae_state_dict_from_jax(variables: Mapping, tokenizer) -> Dict[str, torch.Tensor]:
    """Flax GradVQAutoencoder variables -> state dict for `tokenizer.net`
    (egom2p_torch GradVQAutoencoder): the `core/...` subtree through the
    sequence or video / feature rules, under `core.`; `quantizer/embedding`
    (taming) -> quantizer.embedding.weight, `quantizer/{codes,to_k,to_v}`
    (Memcodes) as they are."""
    from egom2p_torch.tokenizers.seq_vqvae import SeqAutoencoder

    params = _params(variables)
    core_sd = (_seq_core_sd if isinstance(tokenizer.net.core, SeqAutoencoder)
               else _vit_core_sd)(params["core"])
    sd = {f"core.{k}": v for k, v in core_sd.items()}
    for name, arr in _flatten(params["quantizer"]).items():
        sd[f"quantizer.{'embedding.weight' if name == ('embedding',) else '.'.join(name)}"] = arr
    extra = set(params) - {"core", "quantizer"}
    if extra:
        raise KeyError(f"no torch key for JAX params {sorted(extra)}")
    return _checked(sd, tokenizer.net)


def teacher_state_dict_from_jax(variables: Mapping, teacher) -> Dict[str, torch.Tensor]:
    """Flax ViTTeacher variables -> state dict for `teacher` (egom2p_torch
    models/teachers.py:ViTTeacher): the patchify Conv kernel (p, p, 3, W)
    -> (W, 3, p, p), Dense kernels transposed; cls_token, pos_embed, the
    top-level `proj` (width, feat) and LayerScale ls1 / ls2 as they are."""
    sd: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(_params(variables)).items():
        base, leaf = _dotted(path[:-1]), path[-1]
        key = f"{base}.{'weight' if leaf == 'kernel' else leaf}" if base else leaf
        sd[key] = _kernel(arr) if leaf == "kernel" else arr
    return _checked(sd, teacher)
