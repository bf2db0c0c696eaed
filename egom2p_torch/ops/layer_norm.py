"""LayerNorm over the last dim, one fused pass each way, with its gradient.

`layer_norm(x, weight, bias, eps)` is the norm of every EgoM2P block, the
final norms, the qk-norm, the teachers and the VQ-VAEs
(models/transformer.py:LayerNorm; reference: egom2p_utils.py:118-133).
Its precision contract: the per-row mean, the variance, rsqrt and the affine
are computed in fp32, and the output is rounded once to x's dtype.  The
weight and bias reach the kernels in fp32: `layer_norm` takes them in any
float dtype (a teacher cast whole to bf16 holds bf16 ones) and casts them
there, and autograd returns their gradients in their own dtype.

It is a torch.autograd.Function that saves only x in its own dtype and the
fp32 per-row mean and rstd (and the parameters): no fp32 copy of the
activation outlives the forward.

On CUDA tensors `layer_norm_fwd` and `layer_norm_bwd` launch their
hand-written kernels (csrc/layer_norm.cu) or raise; on CPU tensors they run
the plain versions `layer_norm_fwd_reference` / `layer_norm_bwd_reference`
(ATen's native_layer_norm and its backward on an fp32 copy of x).  An empty
x launches nothing and gets empty outputs on either device.  Each wrapper's
`.launches` counts its CUDA calls.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def layer_norm_fwd_reference(x: torch.Tensor, weight: torch.Tensor,
                             bias: Optional[torch.Tensor], eps: float):
    """(y in x's dtype, mean, rstd): the statistics fp32, shaped x.shape[:-1]."""
    y, mean, rstd = torch.native_layer_norm(x.float(), (x.shape[-1],), weight, bias, eps)
    return y.to(x.dtype), mean.squeeze(-1), rstd.squeeze(-1)


def layer_norm_bwd_reference(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                             bias: Optional[torch.Tensor], mean: torch.Tensor,
                             rstd: torch.Tensor):
    """(dx in x's dtype, dweight, dbias or None), the parameters' fp32."""
    dx, dw, db = torch.ops.aten.native_layer_norm_backward(
        dy.float(), x.float(), (x.shape[-1],), mean.unsqueeze(-1), rstd.unsqueeze(-1),
        weight, bias, [True, True, bias is not None])
    return dx.to(x.dtype), dw, db


# the backward kernel's shared memory a block: 2 x warps x dim fp32 sums
SMEM_PER_BLOCK = 227 * 1024
SMEM_PER_SM = 228 * 1024
MAX_BWD_WARPS = 8


def bwd_plan(rows: int, dim: int, n_sm: int) -> Tuple[int, int]:
    """(blocks, warps a block) of the backward kernel: the most warps up to
    8 whose per-warp sums (2 x dim fp32) fit a block's shared memory, and
    one wave of as many blocks as fit on the card (each block adds one
    partial row of the weight's and bias's gradients)."""
    warps = MAX_BWD_WARPS
    while warps > 1 and 8 * warps * dim > SMEM_PER_BLOCK:
        warps //= 2
    smem = 8 * warps * dim
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"the LayerNorm backward kernel takes dim up to "
                         f"{SMEM_PER_BLOCK // 8}, got {dim}")
    per_sm = max(1, min(2048 // (32 * warps), 32, SMEM_PER_SM // (smem + 1024)))
    return max(1, min(-(-rows // warps), n_sm * per_sm)), warps


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _vec(dim: int, *tensors) -> int:
    """4 elements a load where every row starts 4-element aligned, else 1."""
    ok = dim % 4 == 0 and all(t is None or t.data_ptr() % (4 * t.element_size()) == 0
                              for t in tensors)
    return 4 if ok else 1


def _check(x, weight, bias):
    dim = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (dim,) or t.device != x.device:
            raise ValueError(f"layer_norm {name} must be fp32 ({dim},) on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if x.device.type == "cuda" and x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the LayerNorm kernels take fp32 or bf16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"layer_norm runs on CUDA or CPU tensors, not {x.device}")


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                   eps: float):
    """(y, mean, rstd) as `layer_norm_fwd_reference`: the kernel on CUDA,
    the plain version on the CPU."""
    _check(x, weight, bias)
    if x.numel() == 0:
        mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        return torch.empty_like(x), mean, torch.empty_like(mean)
    if x.device.type == "cpu":
        return layer_norm_fwd_reference(x, weight, bias, eps)
    from egom2p_torch.ops import _build

    dim = x.shape[-1]
    xc = x.contiguous()
    rows = xc.numel() // dim
    y = torch.empty_like(xc)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    w, b = weight.contiguous(), None if bias is None else bias.contiguous()
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.egom2p_layer_norm_fwd(xc.data_ptr(), w.data_ptr(),
                                       None if b is None else b.data_ptr(), y.data_ptr(),
                                       mean.data_ptr(), rstd.data_ptr(), rows, dim, eps,
                                       _DTYPE_CODES[x.dtype], _vec(dim, xc, w, b), stream)
    if rc != 0:
        raise RuntimeError(f"LayerNorm forward kernel launch failed with CUDA error {rc}")
    layer_norm_fwd.launches += 1
    return y, mean, rstd


layer_norm_fwd.launches = 0


def layer_norm_bwd(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor], mean: torch.Tensor, rstd: torch.Tensor):
    """(dx, dweight, dbias or None) as `layer_norm_bwd_reference`: the
    kernels on CUDA, the plain version on the CPU."""
    _check(x, weight, bias)
    if x.numel() == 0:
        dw = torch.zeros(x.shape[-1], dtype=torch.float32, device=x.device)
        return torch.empty_like(x), dw, None if bias is None else torch.zeros_like(dw)
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(dy, x, weight, bias, mean, rstd)
    from egom2p_torch.ops import _build

    dim = x.shape[-1]
    xc, dyc = x.contiguous(), dy.to(x.dtype).contiguous()
    rows = xc.numel() // dim
    blocks, warps = bwd_plan(rows, dim,
                             torch.cuda.get_device_properties(x.device).multi_processor_count)
    dx = torch.empty_like(xc)
    partial = torch.empty((2 * blocks, dim), dtype=torch.float32, device=x.device)
    dw = torch.empty(dim, dtype=torch.float32, device=x.device)
    db = None if bias is None else torch.empty_like(dw)
    w = weight.contiguous()
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.egom2p_layer_norm_bwd(dyc.data_ptr(), xc.data_ptr(), w.data_ptr(),
                                       mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                                       partial.data_ptr(), dw.data_ptr(),
                                       None if db is None else db.data_ptr(), rows, dim,
                                       blocks, warps, _DTYPE_CODES[x.dtype],
                                       _vec(dim, xc, dyc, w), stream)
    if rc != 0:
        raise RuntimeError(f"LayerNorm backward kernel launch failed with CUDA error {rc}")
    layer_norm_bwd.launches += 1
    return dx.view(x.shape), dw, db


layer_norm_bwd.launches = 0


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = layer_norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(dy, x, weight, bias, mean, rstd)
        return dx, dw, db, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float) -> torch.Tensor:
    """LayerNorm of x over its last dim, with weight and bias (or None) of
    any float dtype: the kernels take them cast to fp32 (no copy for fp32
    ones), and autograd casts their gradients back."""
    return _LayerNorm.apply(x, weight.float(), None if bias is None else bias.float(), eps)
