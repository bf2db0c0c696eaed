"""Exact-softmax attention in head-major layout: the stock route.

Counterpart of egom2p_tpu/ops/flash_attention.py, which sends attention to
the stock Pallas TPU flash kernel: every attention whose head_dim is not 64
(EgoM2P-large: 15 heads of 68; EgoM2P-xlarge: 31 of 66), and head_dim 64
under the A/B kill switches.  The contract is the JAX one:

- `padding_flash_attention(q, k, v, kv_blocked)` and
  `segment_flash_attention(q, k, v, segments)` take head-major (B, H, N|M,
  hd) q/k/v and return (B, H, N, hd) in q's dtype;
- the softmax is exact (the running-max form) with sm_scale = hd^-0.5 of
  the true head_dim;
- a query row whose every key is blocked (key padding) returns zeros, with
  zero gradients;
- both are differentiable (a torch.autograd.Function).

q/k/v/do are rounded to bf16 for the products; scores and sums are fp32,
p is rounded to bf16 for P.V and P^T.dO, dS for dS.K and dS^T.Q.

On the card the route runs hand-written kernels, one template each for
both head widths: the forward (safemax, with L2) is csrc/flash64_fwd.cu and
the backward the fused dq/dk/dv kernel of csrc/flash64_train.cu (safemax),
both wgmma and TMA, instanced at 64 and 80.  A row of 80 bf16 is 160 bytes
and fits no 128-byte swizzle atom: at 80 every tile is two TMA boxes,
columns 0-63 (128-byte swizzle) and 64-79 (32-byte swizzle).  Heads of
65..80 are zero-padded to 80 (a multiple of the 16 columns of a k-step) and
heads under 64 to 64: zero columns change no score and give zero output and
gradient columns, which are dropped.  The wrapper packs q/k/v (and do) into
contiguous (B, N, H*hd_kernel) buffers before the launch: a head of 68 bf16
is 136 bytes, so the heads of a fused projection do not start on the
16-byte boundaries that the kernels' TMA tile loads need.  On CPU tensors
the wrappers `flash_attention_fwd` / `flash_attention_bwd` run the plain
versions; each counts its CUDA launches in `.launches`.  The fused
backward's dq is summed with fp32 reduce-adds in L2, so it is not bitwise
deterministic.  `flash_attention_reference` is the plain forward on
head-major tensors (dense, in chunks of query rows, with the kernels'
roundings).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from egom2p_torch.ops import flash64_train as ft

MAX_HEAD_DIM = 80


def kernel_head_dim(hd: int) -> Optional[int]:
    """The kernels' head_dim for a true head_dim: 64 up to 64, 80 up to 80,
    None beyond (no kernel)."""
    if 0 < hd <= 64:
        return 64
    if hd <= MAX_HEAD_DIM:
        return 80
    return None


def _pack(t: torch.Tensor, hdk: int) -> torch.Tensor:
    """(B, H, L, hd) -> contiguous bf16-or-input-dtype (B, L, H*hdk), zero
    columns past hd."""
    B, H, L, hd = t.shape
    return F.pad(t.transpose(1, 2), (0, hdk - hd)).reshape(B, L, H * hdk)


def _unpack(t: torch.Tensor, H: int, hd: int) -> torch.Tensor:
    """(B, L, H*hdk) -> (B, H, L, hd), a view."""
    B, L, _ = t.shape
    return t.view(B, L, H, -1)[..., :hd].transpose(1, 2)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes head-major (B, H, N, hd) q and (B, H, M, hd) k, v")
    B, H, N, hd = q.shape
    M = k.shape[2]
    if k.shape != (B, H, M, hd) or v.shape != (B, H, M, hd):
        raise ValueError(f"flash attention shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kernel_head_dim(hd) is None:
        raise ValueError(f"flash attention kernels take head_dim <= {MAX_HEAD_DIM}, got {hd}")
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flash attention runs on CUDA or CPU tensors, not {q.device}")


def padding_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_blocked: Optional[torch.Tensor]) -> torch.Tensor:
    """Attention where masking is pure key padding: kv_blocked (B, M) bool,
    True = blocked, or None.  Fully blocked rows return exact zeros."""
    _check(q, k, v)
    return _attention(q, k, v, kv_blocked, None)


def segment_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            segments: torch.Tensor) -> torch.Tensor:
    """Self-attention restricted to equal segment ids (B, N)."""
    _check(q, k, v)
    return _attention(q, k, v, None, segments)


def _attention(q, k, v, kv_blocked, segments):
    B, H, N, hd = q.shape
    hdk = kernel_head_dim(hd)
    o = _StockFlash.apply(_pack(q, hdk), _pack(k, hdk), _pack(v, hdk), kv_blocked,
                          segments, hdk, hd ** -0.5)
    return _unpack(o, H, hd)


class _StockFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_blocked, segments, hdk, sm_scale):
        o, l2 = flash_attention_fwd(q, k, v, kv_blocked, segments, hd=hdk, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, l2, kv_blocked, segments)
        ctx.hdk, ctx.sm_scale = hdk, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l2, kv_blocked, segments = ctx.saved_tensors
        do = do.contiguous()
        d = ft.row_dot(do, o, ctx.hdk)
        dq, dk, dv = flash_attention_bwd(q, k, v, do, l2, d, kv_blocked, segments,
                                         hd=ctx.hdk, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


# ------------------------------------------------------------- the wrappers
def flash_attention_fwd(q, k, v, kv_blocked=None, segments=None, *, hd: int,
                        sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, L2) of packed (B, N, H*hd) operands, safemax: the forward kernel
    on CUDA, its plain version on the CPU."""
    if q.device.type == "cpu":
        return ft.flash64_train_reference_fwd(q, k, v, kv_blocked, segments, True, hd=hd,
                                              sm_scale=sm_scale)
    out = ft.launch("fwd", q, k, v, kv_blocked, segments, True, hd=hd, sm_scale=sm_scale)
    flash_attention_fwd.launches += 1
    return out


def flash_attention_bwd(q, k, v, do, l2, d, kv_blocked=None, segments=None, *, hd: int,
                        sm_scale: float):
    """(dq, dk, dv) of packed operands from the forward's L2 and
    D = row_dot(do, o): the fused backward kernel on CUDA, its plain
    version on the CPU."""
    if q.device.type == "cpu":
        return ft.flash64_train_reference_dqkv(q, k, v, do, l2, d, kv_blocked, segments, True,
                                               hd=hd, sm_scale=sm_scale)
    out = ft.launch("dqkv", q, k, v, kv_blocked, segments, True, do, l2, d, hd=hd,
                    sm_scale=sm_scale)
    flash_attention_bwd.launches += 1
    return out


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


# ---------------------------------------------------------- plain versions
def flash_attention_reference(q, k, v, kv_blocked=None, segments=None) -> torch.Tensor:
    """Plain PyTorch version of the route's forward on head-major tensors:
    dense, in chunks of query rows, with the kernels' bf16 roundings."""
    _check(q, k, v)
    B, H, N, hd = q.shape
    hdk = kernel_head_dim(hd)
    o, _ = ft.flash64_train_reference_fwd(_pack(q, hdk), _pack(k, hdk), _pack(v, hdk),
                                          kv_blocked, segments, True, hd=hdk,
                                          sm_scale=hd ** -0.5)
    return _unpack(o, H, hd)


def flash_attention_reference_bwd(q, k, v, do, kv_blocked=None, segments=None):
    """Plain version of the route's backward on head-major tensors: (dq, dk,
    dv) for the output gradient `do`, each (B, H, L, hd) in its input's
    dtype."""
    _check(q, k, v)
    B, H, N, hd = q.shape
    hdk = kernel_head_dim(hd)
    qp, kp, vp, dop = (_pack(t, hdk) for t in (q, k, v, do))
    o, l2 = ft.flash64_train_reference_fwd(qp, kp, vp, kv_blocked, segments, True, hd=hdk,
                                           sm_scale=hd ** -0.5)
    grads = ft.flash64_train_reference_dqkv(qp, kp, vp, dop, l2, ft.row_dot(dop, o, hdk),
                                            kv_blocked, segments, True, hd=hdk,
                                            sm_scale=hd ** -0.5)
    return tuple(_unpack(g, H, hd) for g in grads)
