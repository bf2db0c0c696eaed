"""LoRA adapters for EgoM2P fine-tuning.

Port of egom2p_tpu/models/lora.py (reference:
egom2p/models/lora_utils.py:44-177): low-rank factors per attention linear,
trained with the base weights frozen, then fused into the dense weights for
inference.  As in the JAX package the adapters are a separate dict, not
wrapper modules: `merge_lora` gives the effective weights W + scale * (b @
a), and `lora_train_step_fn` runs the unchanged model on them through
torch.func.functional_call, so the forward runs the same modules (and the
same hand-written attention and CE kernels) and gradients reach a and b
only.

Layout: the reference's torch one.  For a Linear weight W (out, in), a is
(r', in) (the reference's lora_down) and b is (out, r') (lora_up); the JAX
package keeps a (in, r') and b (r', out), their transposes
(compat/from_jax.py:lora_state_from_jax converts).  r' is `rank` times the
number of projections a packed weight holds (qkv 3, kv 2).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

# Attention linears only, like the reference's default
# target_replace_modules=ATTENTION_MODULES (lora_utils.py:128-134): the
# encoder's attn.{qkv,proj}, the decoder's self_attn.{qkv,proj} and
# cross_attn.{q,kv,proj}; an ancestor named *attn* keeps e.g. the raw-pixel
# patch embedding's `proj` out.
DEFAULT_TARGETS = ("qkv", "kv", "qk", "qv", "q", "proj")

# packed projections get an n-times-wider bottleneck
# (reference: lora_utils.py:146-153)
_PACKED = {"qkv": 3, "kv": 2, "qk": 2, "qv": 2}


def _is_target(name: str, targets) -> bool:
    path = name.split(".")
    return (len(path) >= 2 and path[-1] == "weight" and path[-2] in targets
            and any("attn" in seg for seg in path[:-2]))


def init_lora_params(params: Mapping[str, torch.Tensor], generator: torch.Generator,
                     rank: int = 4, targets=DEFAULT_TARGETS) -> Dict[str, Dict[str, torch.Tensor]]:
    """{name: {"a": (r', in), "b": (out, r')}} for every attention linear
    weight of `params` (a model's named parameters), fp32 on the weights'
    device: a ~ N(0, 1/rank^2) (the JAX package's normal / rank), b = 0, so
    the adapter starts as a no-op (reference: lora_utils.py:59-69).  The
    draws follow `params`' order, from `generator`."""
    lora = {}
    for name, w in params.items():
        if not _is_target(name, targets):
            continue
        d_out, d_in = w.shape
        r_eff = _PACKED.get(name.split(".")[-2], 1) * rank
        a = torch.randn((r_eff, d_in), generator=generator, device=w.device) / rank
        lora[name] = {"a": a, "b": torch.zeros((d_out, r_eff), device=w.device)}
    return lora


def merge_lora(params: Mapping[str, torch.Tensor], lora: Mapping[str, Dict[str, torch.Tensor]],
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """`params` with W + scale * (b @ a) for each adapted weight (reference
    fuse: lora_utils.py:156-177); the other tensors as they are."""
    out = dict(params)
    for name, ab in lora.items():
        w = params[name]
        out[name] = w + scale * (ab["b"] @ ab["a"]).to(w.dtype)
    return out


def lora_train_step_fn(model: nn.Module, base_params: Optional[Mapping[str, torch.Tensor]] = None,
                       scale: float = 1.0) -> Callable:
    """apply(lora, *args, **kwargs): the model's forward on its base
    parameters (`base_params`, by default its own, detached: frozen) with
    the adapters merged in, so that the loss differentiates only the
    adapters (reference: inject_trainable_LoRA freezes the base,
    lora_utils.py:128-153)."""
    if base_params is None:
        base_params = {k: v.detach() for k, v in model.named_parameters()}

    def apply_with_lora(lora, *args, **kwargs):
        merged = merge_lora(base_params, lora, scale)
        return torch.func.functional_call(model, merged, args, kwargs)

    return apply_with_lora
