"""Inference attention at head_dim 64, in projection layout.

`flash64_attention` is the contract of egom2p_tpu/ops/flash64.py: q/k/v are
(B, N|M, H*64) (views of a fused qkv or kv projection are fine), `kv_blocked`
is an optional (B, M) bool with True = blocked, the result is (B, N, H*64) in
q's dtype.  q/k/v are rounded to bf16, scores and sums are fp32, p is rounded
to bf16 for P.V, and a row whose every key is blocked comes out as exact
zeros (the emptied-CFG convention of ops.attention.masked_attention).

Two softmax forms, as on the TPU (numerics contract in the JAX module's
docstring): the default clamp-only p = exp2(min(s, 80)) with no running max,
and `safemax=True` (or EGOM2P_F64_SAFEMAX=1 when safemax is None), the
running-max online softmax.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
csrc/flash64_fwd.cu (wgmma on 128-row query tiles and 128-key stages that a
producer warp fills by TMA; it masks its own ragged edges, so N and M are
free) or raises.  On a CPU tensor it runs `flash64_attention_reference`, the
plain PyTorch version of the same math.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

HEAD_DIM = 64
NEG_INF = -1e30
# 64^-0.5 * log2(e), rounded to fp32 once: an fp32 tensor times this Python
# float is then exactly the TPU kernel's fp32 multiply
SCALE = float(np.float32((HEAD_DIM ** -0.5) * math.log2(math.e)))
REF_Q_CHUNK = 512


def _resolve_safemax(safemax: Optional[bool]) -> bool:
    if safemax is None:
        return os.environ.get("EGOM2P_F64_SAFEMAX", "0") == "1"
    return bool(safemax)


def _check_args(q, k, v, kv_blocked, hd: int = HEAD_DIM):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash64 takes (B, N, H*{hd}) q and (B, M, H*{hd}) k, v")
    B, N, C = q.shape
    M = k.shape[1]
    if k.shape != (B, M, C) or v.shape != (B, M, C):
        raise ValueError(f"flash64 shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if C % hd or C == 0:
        raise ValueError(f"flash64 needs head_dim {hd}: last dim {C}")
    if N == 0 or M == 0:
        raise ValueError("flash64 needs N > 0 and M > 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_floating_point():
            raise TypeError(f"flash64 {name} must be floating point, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash64 {name} is on {t.device}, q on {q.device}")
    if kv_blocked is not None:
        if tuple(kv_blocked.shape) != (B, M):
            raise ValueError(f"kv_blocked must be (B, M) = {(B, M)}, got "
                             f"{tuple(kv_blocked.shape)}")
        if kv_blocked.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"kv_blocked must be bool or uint8, got {kv_blocked.dtype}")
        if kv_blocked.device != q.device:
            raise ValueError(f"kv_blocked is on {kv_blocked.device}, q on {q.device}")


def flash64_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_blocked: Optional[torch.Tensor] = None,
                      safemax: Optional[bool] = None) -> torch.Tensor:
    """Non-causal attention in projection layout; returns (B, N, H*64).

    `flash64_attention.launches` counts the CUDA kernel launches."""
    _check_args(q, k, v, kv_blocked)
    safemax = _resolve_safemax(safemax)
    if q.device.type == "cpu":
        return flash64_attention_reference(q, k, v, kv_blocked, safemax)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash64 runs on CUDA or CPU tensors, not {q.device}")
    out = _launch(q, k, v, kv_blocked, safemax)
    flash64_attention.launches += 1
    return out


flash64_attention.launches = 0


def _kernel_operand(name: str, t: torch.Tensor) -> torch.Tensor:
    """bf16, unit stride inside a row, a 16-byte aligned base and row and
    batch strides that are multiples of 16 bytes: what the kernel's TMA tile
    loads take (views of a fused qkv or kv projection do).  Other float
    dtypes are rounded to bf16 (the JAX contract); layouts the kernel cannot
    read raise."""
    if t.dtype != torch.bfloat16:
        t = t.to(torch.bfloat16)
    if t.stride(2) != 1:
        raise ValueError(f"flash64 {name} needs unit stride in the last dim, "
                         f"got strides {t.stride()}")
    if t.data_ptr() % 16 or t.stride(1) % 8 or t.stride(0) % 8:
        raise ValueError(f"flash64 {name} rows must be 16-byte aligned: "
                         f"data_ptr % 16 = {t.data_ptr() % 16}, strides {t.stride()}")
    return t


def _launch(q, k, v, kv_blocked, safemax: bool) -> torch.Tensor:
    from egom2p_torch.ops import _build

    B, N, C = q.shape
    M = k.shape[1]
    qb, kb, vb = (_kernel_operand(n, t) for n, t in (("q", q), ("k", k), ("v", v)))
    mask = None
    if kv_blocked is not None:
        mask = kv_blocked if kv_blocked.stride(1) == 1 else kv_blocked.contiguous()
    out = torch.empty((B, N, C), dtype=torch.bfloat16, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.egom2p_flash64_fwd(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, N, M, C // HEAD_DIM,
            qb.stride(0), qb.stride(1), kb.stride(0), kb.stride(1),
            vb.stride(0), vb.stride(1), 0 if mask is None else mask.stride(0),
            out.stride(0), out.stride(1), int(safemax), stream)
    if rc != 0:
        raise RuntimeError(f"flash64 kernel launch failed with CUDA error {rc}")
    return out if q.dtype == torch.bfloat16 else out.to(q.dtype)


def flash64_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                kv_blocked: Optional[torch.Tensor] = None,
                                safemax: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math, in chunks of REF_Q_CHUNK
    query rows so the (B, H, chunk, M) fp32 scores stay bounded (1.7 GB at
    the main path's largest call).

    Safemax takes each row's max over all keys at once: the same softmax as
    the kernel's online form, up to rounding."""
    _check_args(q, k, v, kv_blocked)
    B, N, C = q.shape
    M = k.shape[1]
    H = C // HEAD_DIM

    def heads(t):  # (B, L, H*64) -> bf16-rounded fp32 (B, H, L, 64)
        return (t.to(torch.bfloat16).float().unflatten(-1, (H, HEAD_DIM))
                .transpose(1, 2))

    qh, kh, vh = heads(q), heads(k), heads(v)
    kt = kh.transpose(-1, -2)
    bias = torch.zeros((B, 1, 1, M), dtype=torch.float32, device=q.device)
    if kv_blocked is not None:
        bias = bias.masked_fill(kv_blocked.bool()[:, None, None, :], NEG_INF)
    out = torch.empty((B, H, N, HEAD_DIM), dtype=torch.float32, device=q.device)
    for n0 in range(0, N, REF_Q_CHUNK):
        s = torch.matmul(qh[:, :, n0:n0 + REF_Q_CHUNK], kt) * SCALE + bias
        if safemax:
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp2(s - m)
            live = m > NEG_INF * 0.5
        else:
            p = torch.exp2(torch.clamp(s, max=80.0))
        l = p.sum(dim=-1, keepdim=True)  # from fp32 p, before the bf16 rounding
        if not safemax:
            live = l > 0
        o = torch.matmul(p.to(torch.bfloat16).float(), vh)
        o = o / torch.where(l > 0, l, torch.ones_like(l))
        out[:, :, n0:n0 + REF_Q_CHUNK] = torch.where(live, o, torch.zeros_like(o))
    return out.transpose(1, 2).reshape(B, N, C).to(torch.bfloat16).to(q.dtype)
