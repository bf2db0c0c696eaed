"""Masked dense attention and the inference-attention routing flag.

Port of egom2p_tpu/ops/attention.py.  The mask convention matches the
reference: True means *blocked*, and a fully-blocked query row returns zeros
(classifier-free guidance can empty all conditioning, leaving an encoder
whose every key is blocked).

`inference_attention()` marks generation: inside it, eligible attention
calls route to the flash64 kernel, outside it to the training kernels of
flash64_train (models/transformer.py:_try_flash64).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e30  # large negative instead of finfo.min: safe under bf16 -> fp32 casts

_INFERENCE_ATTN = False


@contextlib.contextmanager
def inference_attention():
    global _INFERENCE_ATTN
    prev = _INFERENCE_ATTN
    _INFERENCE_ATTN = True
    try:
        yield
    finally:
        _INFERENCE_ATTN = prev


def inference_attention_active() -> bool:
    return _INFERENCE_ATTN


class SegmentMask(NamedTuple):
    """Self-attention restricted to equal segment ids (B, N).

    The EgoM2P decoder's training mask for image-type modalities reduces to
    this: with the modality separation mask, every token's budget window
    covers its own modality block, so attention is "same modality only".
    Masked positions carry the id -1 and attend to each other; their loss
    weight is 0."""
    segments: torch.Tensor  # (B, N) int


def key_padding_mask(mask) -> Tuple[bool, Optional[torch.Tensor]]:
    """(is_key_padding, (B, M) blocked-bool or None) for a module-level mask:
    None, (B, 1, M) or (B, 1, 1, M) are key padding."""
    if mask is None:
        return True, None
    if isinstance(mask, SegmentMask):
        return False, None
    if mask.dim() == 3 and mask.shape[1] == 1:
        return True, mask[:, 0]
    if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        return True, mask[:, 0, 0]
    return False, None


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, *,
                     softmax1: bool = False) -> torch.Tensor:
    """Dense attention over (B, H, N, hd) q and (B, H, M, hd) k/v; `mask`
    broadcasts to (B, H, N, M) with True = blocked, or is a SegmentMask
    (blocked where the segments differ).  Returns (B, H, N, hd).

    Scores and softmax are fp32 (the JAX einsum's fp32 accumulation); the
    weights are cast to v's dtype for the second product."""
    if isinstance(mask, SegmentMask):
        seg = mask.segments
        mask = (seg[:, None, :] != seg[:, :, None])[:, None]
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(mask, NEG_INF)
    if softmax1:
        # off-by-one softmax: allows attending to "nothing"
        m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=0.0)
        unnorm = torch.exp(logits - m)
        weights = unnorm / (unnorm.sum(dim=-1, keepdim=True) + torch.exp(-m))
    else:
        weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(v.dtype), v)
    if mask is not None:
        fully_blocked = torch.broadcast_to(mask, logits.shape).all(dim=-1)
        out = out.masked_fill(fully_blocked[..., None], 0.0)
    return out
