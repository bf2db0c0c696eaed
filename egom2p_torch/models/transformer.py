"""Transformer primitives for the EgoM2P encoder-decoder.

Port of egom2p_tpu/models/transformer.py (reference blocks:
egom2p/models/egom2p_utils.py:118-412).  Submodule and parameter names follow
the reference torch state-dict keys (qkv / proj / fc1 / fc2 / fc3 / norm1 /
...).  Parameters stay fp32 and every matmul runs in the dtype of its input
(the model's compute dtype); norms and softmax compute in fp32.

q/k/v stay views of the fused `qkv` / `kv` projection in (B, N, H*64)
layout: eligible attention goes to the flash64 kernels with no head
transposes (generation to the inference kernel, training to the
differentiable flash64_train kernels).  Other heads (EgoM2P-large's 68) and
the kill switches split the heads for masked_attention's stock route.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from egom2p_torch.ops.attention import (SegmentMask, generation_trace_active,
                                        inference_attention_active, key_padding_mask,
                                        masked_attention)


def gelu(x):
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu default


ACTIVATIONS = {"gelu": gelu, "silu": F.silu}


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype (weights cast at use, the
    flax Dense(dtype=compute_dtype) policy)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.Module):
    """LayerNorm with optional bias, computed in fp32
    (reference: egom2p_utils.py:118-133)."""

    def __init__(self, dim: int, eps: float = 1e-6, bias: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if bias else None

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, act: Callable = gelu,
                 bias: bool = True, out_dim: Optional[int] = None):
        super().__init__()
        self.act = act
        self.fc1 = Linear(dim, hidden_dim, bias=bias)
        self.fc2 = Linear(hidden_dim, out_dim or dim, bias=bias)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class GatedMlp(nn.Module):
    """SwiGLU-style gated feed-forward; the hidden size is int(2*hidden/3)
    to keep FLOPs comparable (reference: egom2p_utils.py:154-169)."""

    def __init__(self, dim: int, hidden_dim: int, act: Callable = F.silu,
                 bias: bool = True):
        super().__init__()
        hidden = int(2 * hidden_dim / 3)
        self.act = act
        self.fc1 = Linear(dim, hidden, bias=bias)   # gate
        self.fc3 = Linear(dim, hidden, bias=bias)   # value
        self.fc2 = Linear(hidden, dim, bias=bias)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)) * self.fc3(x))


def _split_heads(x, num_heads):
    return x.unflatten(-1, (num_heads, -1)).transpose(1, 2)  # (B, H, N, hd)


def _merge_heads(x):
    return x.transpose(1, 2).flatten(-2)


def _try_flash64(q, k, v, mask, num_heads: int, softmax1: bool):
    """Route an eligible attention call to a flash64 kernel in projection
    layout (B, N, C); returns the output or None (the caller then splits
    the heads and calls masked_attention: the stock route or dense).

    Eligible, as in egom2p_tpu/models/transformer.py:_try_flash64: no
    softmax1, head_dim 64 with whole head pairs, N*M >= 256^2, M <= 16384.
    During generation (`inference_attention()`) a key-padding mask or none
    goes to the inference kernel, or with EGOM2P_FLASH64=0 to the stock
    route, never to a training kernel.  Otherwise a key-padding mask or none,
    or a SegmentMask with N == M, goes to flash64_train_attention, unless
    EGOM2P_FLASH64_TRAIN=0 (both) or EGOM2P_F64T_SEG=0 (segments) sends it
    to the stock route.  Eligibility does not depend on the device: CPU
    tensors take the kernels' plain versions."""
    C = q.shape[-1]
    if (softmax1 or C % 128 != 0 or C // num_heads != 64
            or q.shape[1] * k.shape[1] < 256 * 256 or k.shape[1] > 16384):
        return None
    from egom2p_torch.ops.flash64_train import flash64_train_attention
    train_off = os.environ.get("EGOM2P_FLASH64_TRAIN", "1") == "0"
    if isinstance(mask, SegmentMask):
        if (generation_trace_active() or q.shape[1] != k.shape[1] or train_off
                or os.environ.get("EGOM2P_F64T_SEG", "1") == "0"):
            return None
        return flash64_train_attention(q, k, v, segments=mask.segments)
    is_kp, kv_blocked = key_padding_mask(mask)
    if not is_kp:
        return None
    if generation_trace_active():
        if not inference_attention_active():
            return None
        from egom2p_torch.ops.flash64 import flash64_attention
        return flash64_attention(q, k, v, kv_blocked)
    if train_off:
        return None
    return flash64_train_attention(q, k, v, kv_blocked)


class _AttentionBase(nn.Module):
    def __init__(self, dim: int, num_heads: int, proj_bias: bool,
                 qk_norm: bool, norm_bias: bool, softmax1: bool):
        super().__init__()
        self.num_heads = num_heads
        self.softmax1 = softmax1
        if qk_norm:
            self.q_norm = LayerNorm(dim // num_heads, bias=norm_bias)
            self.k_norm = LayerNorm(dim // num_heads, bias=norm_bias)
        else:
            self.q_norm = self.k_norm = None
        self.proj = Linear(dim, dim, bias=proj_bias)

    def _attend(self, q, k, v, mask):
        if self.q_norm is not None:  # per-head LN, layout-free
            q = self.q_norm(q.unflatten(-1, (self.num_heads, -1))).flatten(-2)
            k = self.k_norm(k.unflatten(-1, (self.num_heads, -1))).flatten(-2)
        fast = _try_flash64(q, k, v, mask, self.num_heads, self.softmax1)
        if fast is not None:
            return self.proj(fast)
        q, k, v = (_split_heads(t, self.num_heads) for t in (q, k, v))
        if isinstance(mask, torch.Tensor) and mask.dim() == 3:
            mask = mask[:, None]  # add the head dim
        out = masked_attention(q, k, v, mask, softmax1=self.softmax1)
        return self.proj(_merge_heads(out))


class Attention(_AttentionBase):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 proj_bias: bool = True, qk_norm: bool = False,
                 norm_bias: bool = True, softmax1: bool = False):
        super().__init__(dim, num_heads, proj_bias, qk_norm, norm_bias, softmax1)
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)

    def forward(self, x, mask=None):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self._attend(q, k, v, mask)


class CrossAttention(_AttentionBase):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 proj_bias: bool = True, qk_norm: bool = False,
                 norm_bias: bool = True, softmax1: bool = False):
        super().__init__(dim, num_heads, proj_bias, qk_norm, norm_bias, softmax1)
        self.q = Linear(dim, dim, bias=qkv_bias)
        self.kv = Linear(dim, 2 * dim, bias=qkv_bias)

    def forward(self, x, context, mask=None):
        k, v = self.kv(context).chunk(2, dim=-1)
        return self._attend(self.q(x), k, v, mask)


def _mlp(dim, mlp_ratio, gated_mlp, act, mlp_bias):
    cls = GatedMlp if gated_mlp else Mlp
    return cls(dim, int(dim * mlp_ratio), act=act, bias=mlp_bias)


def drop_path(h: torch.Tensor, rate: float, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """Stochastic depth per sample (reference: egom2p_utils.py:89-100): a
    residual branch `h` (B, N, C) scaled by 1 / (1 - rate) where `keep` (B,)
    is 1 and zeroed where it is 0; the identity without `keep` (eval)."""
    if keep is None or rate == 0.0:
        return h
    return h / (1.0 - rate) * keep.to(h.dtype)[:, None, None]


class Block(nn.Module):
    """Pre-norm self-attention block (reference: egom2p_utils.py:335-359)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, proj_bias: bool = True,
                 mlp_bias: bool = True, norm_bias: bool = True,
                 gated_mlp: bool = False, qk_norm: bool = False,
                 act: Callable = gelu, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, bias=norm_bias)
        self.attn = Attention(dim, num_heads, qkv_bias, proj_bias, qk_norm,
                              norm_bias)
        self.norm2 = LayerNorm(dim, bias=norm_bias)
        self.mlp = _mlp(dim, mlp_ratio, gated_mlp, act, mlp_bias)

    def forward(self, x, mask=None, keep=None):
        """`keep` (2, B): the drawn stochastic-depth masks of the attention
        and MLP branches, or None."""
        k = (None, None) if keep is None else keep
        x = x + drop_path(self.attn(self.norm1(x), mask), self.drop_path, k[0])
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path, k[1])


class DecoderBlock(nn.Module):
    """Self-attn + cross-attn + MLP (reference: egom2p_utils.py:362-391)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, proj_bias: bool = True,
                 mlp_bias: bool = True, norm_bias: bool = True,
                 gated_mlp: bool = False, qk_norm: bool = False,
                 act: Callable = gelu, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, bias=norm_bias)
        self.self_attn = Attention(dim, num_heads, qkv_bias, proj_bias,
                                   qk_norm, norm_bias)
        self.query_norm = LayerNorm(dim, bias=norm_bias)
        self.context_norm = LayerNorm(dim, bias=norm_bias)
        self.cross_attn = CrossAttention(dim, num_heads, qkv_bias, proj_bias,
                                         qk_norm, norm_bias)
        self.norm2 = LayerNorm(dim, bias=norm_bias)
        self.mlp = _mlp(dim, mlp_ratio, gated_mlp, act, mlp_bias)

    def forward(self, x, context, sa_mask=None, xa_mask=None, keep=None):
        """`keep` (3, B): the stochastic-depth masks of the self-attention,
        cross-attention and MLP branches, or None."""
        k = (None, None, None) if keep is None else keep
        x = x + drop_path(self.self_attn(self.norm1(x), sa_mask), self.drop_path, k[0])
        x = x + drop_path(self.cross_attn(self.query_norm(x), self.context_norm(context),
                                          xa_mask), self.drop_path, k[1])
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path, k[2])
