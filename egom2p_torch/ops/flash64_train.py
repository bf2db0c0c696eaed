"""Training attention at head_dim 64, in projection layout, with its gradient.

`flash64_train_attention` is the contract of egom2p_tpu/ops/flash64_train.py:
q/k/v are (B, N|M, H*64) with an even H (views of a fused qkv or kv
projection are fine), the mask is either `kv_blocked` (B, M) bool with True
= blocked (key padding) or `segments` (B, N) int ids (self-attention only:
a query sees the keys of its own segment), never both, and the result is
(B, N, H*64) in q's dtype.  q/k/v/do are rounded to bf16 for the products,
scores and sums are fp32, p is rounded to bf16 for P.V and P^T.dO, dS for
dS.K and dS^T.Q, and a row whose every key is blocked comes out as exact
zeros, with zero gradients.  The softmax is clamp-only by default
(EGOM2P_F64T_SAFEMAX=1, or safemax=True, selects the running-max form); the
backward recomputes p = exp2(s - L2) from the forward's per-row L2 with the
same clamp.

It is a torch.autograd.Function.  The forward launches the forward kernel
(csrc/flash64_fwd.cu, its L2 instance) and keeps o and L2; the backward forms
D = rowsum(do * o) per head in fp32 and launches the dq kernel and the dk/dv
kernel (csrc/flash64_train.cu), or, when EGOM2P_F64T_FUSED_BWD=1 at the time
the backward runs, the one fused dq/dk/dv kernel.  The fused kernel sums dq
in fp32 with atomic adds, in an order that changes from run to run, so its
dq is not bitwise deterministic; dq then leaves fp32 in q's dtype (the JAX
package's fused kernel does the same), where the split kernel rounds it to
bf16 first.  On CUDA tensors the wrappers `flash64_train_fwd`,
`flash64_train_dq`, `flash64_train_dkv` and `flash64_train_dqkv` launch
their kernels or raise; on CPU tensors they run the plain PyTorch versions
`flash64_train_reference_fwd`, `_dq`, `_dkv` and `_dqkv` (`_bwd` gives the
split kernels' three gradients).  Each wrapper's `.launches` counts its CUDA
launches.  No gradient goes to the mask or the segments.

The forward and fused kernels also serve ops/flash_attention.py (the stock
route) at head_dim 80: every function here takes `hd` (the kernel's head
dim, 64 or 80) and `sm_scale` (the true head's natural scale, hd^-0.5 by
default) as keywords.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from egom2p_torch.ops.flash64 import HEAD_DIM, NEG_INF, _check_args, _kernel_operand

DEAD_L2 = 1e30                # L2 of a row with no live key: p = 0 in the backward
REF_Q_CHUNK = 512


def _resolve_safemax(safemax: Optional[bool]) -> bool:
    if safemax is None:
        return os.environ.get("EGOM2P_F64T_SAFEMAX", "0") == "1"
    return bool(safemax)


def _scales(hd: int, sm_scale: Optional[float]) -> Tuple[float, float]:
    """(natural scale, exp2-domain scale), both rounded to fp32 as the
    kernels hold them: an fp32 tensor times either Python float is then
    exactly the kernel's fp32 multiply."""
    nat = float(np.float32(hd ** -0.5 if sm_scale is None else sm_scale))
    return nat, float(np.float32(nat * math.log2(math.e)))


def _check(q, k, v, kv_blocked, segments, hd: int = HEAD_DIM):
    _check_args(q, k, v, kv_blocked, hd)
    if segments is None:
        return
    if kv_blocked is not None:
        raise ValueError("kv_blocked and segments are exclusive")
    if q.shape[1] != k.shape[1]:
        raise ValueError("segment mode is self-attention only")
    if tuple(segments.shape) != tuple(q.shape[:2]):
        raise ValueError(f"segments must be (B, N) = {tuple(q.shape[:2])}, got "
                         f"{tuple(segments.shape)}")
    if segments.is_floating_point() or segments.dtype == torch.bool:
        raise TypeError(f"segments must be integer ids, got {segments.dtype}")
    if segments.device != q.device:
        raise ValueError(f"segments is on {segments.device}, q on {q.device}")


def flash64_train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_blocked: Optional[torch.Tensor] = None,
                            segments: Optional[torch.Tensor] = None,
                            safemax: Optional[bool] = None) -> torch.Tensor:
    """Differentiable non-causal attention in projection layout; returns
    (B, N, H*64) in q's dtype."""
    _check(q, k, v, kv_blocked, segments)
    if q.shape[-1] % (2 * HEAD_DIM):
        raise ValueError("flash64_train needs an even count of 64-dim heads")
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flash64_train runs on CUDA or CPU tensors, not {q.device}")
    return _Flash64Train.apply(q, k, v, kv_blocked, segments, _resolve_safemax(safemax))


def fused_bwd_enabled() -> bool:
    return os.environ.get("EGOM2P_F64T_FUSED_BWD", "0") == "1"


class _Flash64Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_blocked, segments, safemax):
        o, l2 = flash64_train_fwd(q, k, v, kv_blocked, segments, safemax)
        ctx.save_for_backward(q, k, v, o, l2, kv_blocked, segments)
        ctx.safemax = safemax
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l2, kv_blocked, segments = ctx.saved_tensors
        do = do.contiguous()  # autograd may hand an expanded gradient (of a sum)
        d = row_dot(do, o)
        args = (q, k, v, do, l2, d, kv_blocked, segments, ctx.safemax)
        if fused_bwd_enabled():
            dq, dk, dv = flash64_train_dqkv(*args)
        else:
            dq = flash64_train_dq(*args)
            dk, dv = flash64_train_dkv(*args)
        return dq, dk, dv, None, None, None


def row_dot(do: torch.Tensor, o: torch.Tensor, hd: int = HEAD_DIM) -> torch.Tensor:
    """D = rowsum(do * o) per head, fp32 (B, H, N): do as given (bf16 in
    training) and the forward's bf16-valued o, widened to fp32."""
    B, N, C = o.shape
    d = (do.float() * o.float()).view(B, N, C // hd, hd).sum(-1)
    return d.transpose(1, 2).contiguous()


# ------------------------------------------------------------- the wrappers
def flash64_train_fwd(q, k, v, kv_blocked=None, segments=None, safemax=False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (B, N, H*64) in q's dtype, L2 (B, H, N) fp32): the forward kernel
    on CUDA, its plain version on the CPU."""
    if q.device.type == "cpu":
        return flash64_train_reference_fwd(q, k, v, kv_blocked, segments, safemax)
    out = launch("fwd", q, k, v, kv_blocked, segments, safemax)
    flash64_train_fwd.launches += 1
    return out


def flash64_train_dq(q, k, v, do, l2, d, kv_blocked=None, segments=None,
                     safemax=False) -> torch.Tensor:
    """dq in q's dtype from the forward's L2 and D = row_dot(do, o)."""
    if q.device.type == "cpu":
        return flash64_train_reference_dq(q, k, v, do, l2, d, kv_blocked, segments, safemax)
    out = launch("dq", q, k, v, kv_blocked, segments, safemax, do, l2, d)
    flash64_train_dq.launches += 1
    return out


def flash64_train_dkv(q, k, v, do, l2, d, kv_blocked=None, segments=None,
                      safemax=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in k's and v's dtypes."""
    if q.device.type == "cpu":
        return flash64_train_reference_dkv(q, k, v, do, l2, d, kv_blocked, segments, safemax)
    out = launch("dkv", q, k, v, kv_blocked, segments, safemax, do, l2, d)
    flash64_train_dkv.launches += 1
    return out


def flash64_train_dqkv(q, k, v, do, l2, d, kv_blocked=None, segments=None,
                       safemax=False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's, k's and v's dtypes from the one fused kernel;
    dq is summed in fp32 by atomic adds (not bitwise deterministic)."""
    if q.device.type == "cpu":
        return flash64_train_reference_dqkv(q, k, v, do, l2, d, kv_blocked, segments, safemax)
    out = launch("dqkv", q, k, v, kv_blocked, segments, safemax, do, l2, d)
    flash64_train_dqkv.launches += 1
    return out


flash64_train_fwd.launches = 0
flash64_train_dq.launches = 0
flash64_train_dkv.launches = 0
flash64_train_dqkv.launches = 0


def _f32_rows(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
        raise ValueError(f"flash64_train {name} must be fp32 {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def launch(which: str, q, k, v, kv_blocked, segments, safemax: bool,
           do=None, l2=None, d=None, *, hd: int = HEAD_DIM,
           sm_scale: Optional[float] = None):
    """Launch one of the kernels ("fwd", "dq", "dkv" or "dqkv") on q's
    device and stream; counts nothing (the callers do)."""
    from egom2p_torch.ops import _build

    if q.device.type != "cuda":
        raise RuntimeError(f"flash64_train kernels run on CUDA tensors, not {q.device}")
    _check(q, k, v, kv_blocked, segments, hd)
    B, N, C = q.shape
    M, H = k.shape[1], C // hd
    nat, _ = _scales(hd, sm_scale)
    qb, kb, vb = (_kernel_operand(n, t) for n, t in (("q", q), ("k", k), ("v", v)))
    mask = seg = None
    if kv_blocked is not None:
        mask = kv_blocked if kv_blocked.stride(1) == 1 else kv_blocked.contiguous()
    if segments is not None:
        seg = segments.to(torch.int32)
        seg = seg if seg.stride(1) == 1 else seg.contiguous()
    m_arr = mask if mask is not None else seg
    m_sb = 0 if m_arr is None else m_arr.stride(0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    strides = (qb.stride(0), qb.stride(1), kb.stride(0), kb.stride(1),
               vb.stride(0), vb.stride(1))
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "fwd":
            out = torch.empty((B, N, C), dtype=torch.bfloat16, device=q.device)
            lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
            rc = lib.egom2p_flash64_train_fwd(
                qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), ptr(mask), ptr(seg),
                out.data_ptr(), lse.data_ptr(), B, N, M, H, *strides, m_sb,
                out.stride(0), out.stride(1), int(safemax), hd, nat, stream)
            result = (out.to(q.dtype), lse)
        else:
            dob = _kernel_operand("do", do)
            if tuple(dob.shape) != (B, N, C):
                raise ValueError(f"flash64_train do must be {(B, N, C)}, got {tuple(dob.shape)}")
            l2c, dc = _f32_rows("L2", l2, (B, H, N)), _f32_rows("D", d, (B, H, N))
            common = (qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), dob.data_ptr(),
                      l2c.data_ptr(), dc.data_ptr(), ptr(mask), ptr(seg))
            tail = (B, N, M, H, *strides, dob.stride(0), dob.stride(1), m_sb,
                    int(safemax), hd, nat, stream)
            if which == "dq":
                dq = torch.empty((B, N, C), dtype=torch.bfloat16, device=q.device)
                rc = lib.egom2p_flash64_train_dq(*common, dq.data_ptr(), *tail)
                result = dq.to(q.dtype)
            else:
                dk = torch.empty((B, M, C), dtype=torch.bfloat16, device=q.device)
                dv = torch.empty((B, M, C), dtype=torch.bfloat16, device=q.device)
                if which == "dkv":
                    rc = lib.egom2p_flash64_train_dkv(*common, dk.data_ptr(), dv.data_ptr(),
                                                      *tail)
                    result = (dk.to(k.dtype), dv.to(v.dtype))
                else:
                    dq = torch.zeros((B, N, C), dtype=torch.float32, device=q.device)
                    rc = lib.egom2p_flash64_train_dqkv(*common, dq.data_ptr(), dk.data_ptr(),
                                                       dv.data_ptr(), *tail)
                    result = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if rc != 0:
        raise RuntimeError(f"flash64_train {which} kernel launch failed with CUDA error {rc}")
    return result


# ---------------------------------------------------------- plain versions
def _heads(t, H, hd=HEAD_DIM):
    """(B, L, H*hd) -> bf16-rounded fp32 (B, H, L, hd)."""
    return t.to(torch.bfloat16).float().unflatten(-1, (H, hd)).transpose(1, 2)


def _bias(kv_blocked, segments, B, M, n0, n1, device):
    """fp32 additive mask for query rows n0:n1, broadcastable to
    (B, H, n1 - n0, M): -1e30 where blocked."""
    if segments is not None:
        seg = segments.long()
        differ = seg[:, None, n0:n1, None] != seg[:, None, None, :]
        return torch.where(differ, NEG_INF, 0.0).float()
    bias = torch.zeros((B, 1, 1, M), dtype=torch.float32, device=device)
    if kv_blocked is not None:
        bias = bias.masked_fill(kv_blocked.bool()[:, None, None, :], NEG_INF)
    return bias


def flash64_train_reference_fwd(q, k, v, kv_blocked=None, segments=None,
                                safemax=False, *, hd: int = HEAD_DIM,
                                sm_scale: Optional[float] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: (o in q's dtype, L2 (B,
    H, N) fp32), in chunks of REF_Q_CHUNK query rows.  Safemax takes each
    row's max over all keys at once: the kernel's online softmax, up to
    rounding."""
    _check(q, k, v, kv_blocked, segments, hd)
    B, N, C = q.shape
    M, H = k.shape[1], C // hd
    _, scale = _scales(hd, sm_scale)
    qh, kh, vh = _heads(q, H, hd), _heads(k, H, hd), _heads(v, H, hd)
    kt = kh.transpose(-1, -2)
    out = torch.empty((B, H, N, hd), dtype=torch.float32, device=q.device)
    l2 = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    for n0 in range(0, N, REF_Q_CHUNK):
        n1 = min(n0 + REF_Q_CHUNK, N)
        s = torch.matmul(qh[:, :, n0:n1], kt) * scale + _bias(
            kv_blocked, segments, B, M, n0, n1, q.device)
        if safemax:
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp2(s - m)
            live = m > NEG_INF * 0.5
        else:
            m = torch.zeros_like(s[..., :1])
            p = torch.exp2(torch.clamp(s, max=80.0))
        l = p.sum(dim=-1, keepdim=True)  # from fp32 p, before the bf16 rounding
        if not safemax:
            live = l > 0
        denom = torch.where(l > 0, l, torch.ones_like(l))
        o = torch.matmul(p.to(torch.bfloat16).float(), vh) / denom
        out[:, :, n0:n1] = torch.where(live, o, torch.zeros_like(o))
        l2[:, :, n0:n1] = torch.where(live, m + torch.log2(denom),
                                      torch.full_like(l, DEAD_L2))[..., 0]
    o = out.transpose(1, 2).reshape(B, N, C).to(torch.bfloat16).to(q.dtype)
    return o, l2


def flash64_train_reference_bwd(q, k, v, o, l2, do, kv_blocked=None, segments=None,
                                safemax=False):
    """Plain PyTorch version of the two backward kernels: (dq, dk, dv) in
    q's, k's and v's dtypes, computed explicitly (not by autograd) in chunks
    of REF_Q_CHUNK query rows, with the kernels' bf16 roundings."""
    _check(q, k, v, kv_blocked, segments)
    return _reference_bwd(q, k, v, do, l2, row_dot(do, o), kv_blocked, segments,
                          safemax, want_dq=True, want_dkv=True)


def flash64_train_reference_dq(q, k, v, do, l2, d, kv_blocked=None, segments=None,
                               safemax=False) -> torch.Tensor:
    """Plain version of the dq kernel (the arguments of flash64_train_dq)."""
    return _reference_bwd(q, k, v, do, l2, d, kv_blocked, segments, safemax,
                          want_dq=True, want_dkv=False)[0]


def flash64_train_reference_dkv(q, k, v, do, l2, d, kv_blocked=None, segments=None,
                                safemax=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel (the arguments of flash64_train_dkv)."""
    return _reference_bwd(q, k, v, do, l2, d, kv_blocked, segments, safemax,
                          want_dq=False, want_dkv=True)[1:]


def flash64_train_reference_dqkv(q, k, v, do, l2, d, kv_blocked=None, segments=None,
                                 safemax=False, *, hd: int = HEAD_DIM,
                                 sm_scale: Optional[float] = None):
    """Plain version of the fused kernel (the arguments of
    flash64_train_dqkv): the split kernels' math, with dq left in fp32 until
    the cast to q's dtype."""
    _check(q, k, v, kv_blocked, segments, hd)
    return _reference_bwd(q, k, v, do, l2, d, kv_blocked, segments, safemax,
                          want_dq=True, want_dkv=True, dq_f32=True, hd=hd,
                          sm_scale=sm_scale)


def _reference_bwd(q, k, v, do, l2, d, kv_blocked, segments, safemax, *,
                   want_dq: bool, want_dkv: bool, dq_f32: bool = False,
                   hd: int = HEAD_DIM, sm_scale: Optional[float] = None):
    B, N, C = q.shape
    M, H = k.shape[1], C // hd
    nat, scale = _scales(hd, sm_scale)
    qh, kh, vh, doh = (_heads(t, H, hd) for t in (q, k, v, do))
    kt, vt = kh.transpose(-1, -2), vh.transpose(-1, -2)
    dq = torch.empty_like(qh) if want_dq else None
    dk = torch.zeros_like(kh) if want_dkv else None
    dv = torch.zeros_like(vh) if want_dkv else None
    for n0 in range(0, N, REF_Q_CHUNK):
        n1 = min(n0 + REF_Q_CHUNK, N)
        s = torch.matmul(qh[:, :, n0:n1], kt) * scale + _bias(
            kv_blocked, segments, B, M, n0, n1, q.device)
        if not safemax:  # the forward's clamp, before subtracting L2
            s = torch.clamp(s, max=80.0)
        p = torch.exp2(s - l2[:, :, n0:n1, None])
        do_c = doh[:, :, n0:n1]
        ds = p * (torch.matmul(do_c, vt) - d[:, :, n0:n1, None])
        ds = ds.to(torch.bfloat16).float()
        if want_dq:
            dq[:, :, n0:n1] = torch.matmul(ds, kh) * nat
        if want_dkv:
            dv += torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2), do_c)
            dk += torch.matmul(ds.transpose(-1, -2), qh[:, :, n0:n1])

    def back(t, like, rounded=True):  # (B, H, L, hd) fp32 -> (B, L, H*hd) in like's dtype
        t = t.transpose(1, 2).reshape(B, -1, C)
        return (t.to(torch.bfloat16) if rounded else t).to(like.dtype)

    return (back(dq, q, rounded=not dq_f32) if want_dq else None,
            back(dk * nat, k) if want_dkv else None,
            back(dv, v) if want_dkv else None)
