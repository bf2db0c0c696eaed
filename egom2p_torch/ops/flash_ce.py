"""Cross-entropy of the large-vocab heads without materialized logits.

`flash_ce_total(y, w_mat, targets, wts)` is the contract of
egom2p_tpu/ops/flash_ce.py: the sum over rows of wts * (logz - gold) for
logits = y @ w_mat.T, with w_mat cast to y's dtype for the products (bf16 in
training) and fp32 logits.  It is a torch.autograd.Function, differentiable
in y and w_mat; targets and wts get no gradient.

Forward: `row_stats(y, w, targets)` -> (logz, gold) per row.  On a CUDA
tensor it launches the hand-written kernel csrc/flash_ce_fwd.cu (online
logsumexp over vocab tiles; the logits never reach device memory) or raises;
on a CPU tensor it runs `row_stats_reference`, the plain version.
`row_stats.launches` counts the CUDA launches.

Backward, by default: the chunked recompute of the JAX package's
`_bwd_chunked`, in plain PyTorch (the JAX package runs it in XLA, not in
Pallas): per chunk of rows, fp32 logits, p = exp(logits - logz),
dl = (p - onehot) * wts * g rounded to w's dtype, dy = dl @ w, dW += dl^T @ y
summed in fp32 and cast to w_mat's dtype.  With EGOM2P_CE_PALLAS_BWD=1 at
the time the backward runs, `ce_bwd(y, w, targets, wc, logz)` -> (dy, dW),
both fp32, computes the same in the hand-written kernel
csrc/flash_ce_bwd.cu (the logits never reach device memory; a CUDA tensor
it cannot take raises) or, on a CPU tensor, in `ce_bwd_reference`, the
chunked recompute with fp32 dy.  `ce_bwd.launches` counts its CUDA calls.
"""
from __future__ import annotations

import contextlib
import os
from typing import Tuple

import torch

REF_CHUNK = 2048


@contextlib.contextmanager
def _tf32_matmuls(enabled: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled or prev
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 product a @ b of two tensors of one dtype, with fp32 sums.

    A bf16 value is exact in TF32 (10 mantissa bits hold bf16's 7), so on a
    CUDA device the product of bf16 operands runs on the TF32 tensor cores
    with no rounding of its inputs: the same numbers as a full fp32 product,
    up to the order of the sums.  Other dtypes compute in full fp32."""
    with _tf32_matmuls(a.is_cuda and a.dtype == b.dtype == torch.bfloat16):
        return torch.matmul(a.float(), b.float())


def _check(y, w, targets):
    if y.dim() != 2 or w.dim() != 2 or y.shape[1] != w.shape[1]:
        raise ValueError(f"flash_ce takes y (R, D) and w (V, D), got {tuple(y.shape)}, "
                         f"{tuple(w.shape)}")
    if tuple(targets.shape) != (y.shape[0],):
        raise ValueError(f"targets must be (R,) = ({y.shape[0]},), got {tuple(targets.shape)}")
    if y.shape[1] % 128:
        raise ValueError(f"flash_ce needs the model dim to be a multiple of 128, got {y.shape[1]}")
    for name, t in (("w", w), ("targets", targets)):
        if t.device != y.device:
            raise ValueError(f"flash_ce {name} is on {t.device}, y on {y.device}")


def row_stats(y: torch.Tensor, w: torch.Tensor, targets: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logz, gold), two fp32 (R,) vectors, of the logits y @ w.T; w has
    y's dtype.  The kernel on CUDA, the plain version on the CPU."""
    _check(y, w, targets)
    if y.device.type == "cpu":
        return row_stats_reference(y, w, targets)
    if y.device.type != "cuda":
        raise RuntimeError(f"flash_ce runs on CUDA or CPU tensors, not {y.device}")
    out = _launch(y, w, targets)
    row_stats.launches += 1
    return out


row_stats.launches = 0


def _kernel_operand(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"the flash_ce kernel takes bf16 {name}, got {t.dtype}")
    if t.stride(1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
        raise ValueError(f"flash_ce {name} needs 16-byte aligned rows with unit stride, "
                         f"got strides {t.stride()}")
    return t


def _launch(y, w, targets):
    from egom2p_torch.ops import _build

    R, D = y.shape
    if D > 768:
        raise ValueError(f"the flash_ce kernel keeps 128 rows of y in shared memory: "
                         f"D <= 768, got {D}")
    yb, wb = _kernel_operand("y", y), _kernel_operand("w", w)
    t = targets.to(torch.int32).contiguous()
    logz = torch.empty(R, dtype=torch.float32, device=y.device)
    gold = torch.empty(R, dtype=torch.float32, device=y.device)
    lib = _build.load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.egom2p_flash_ce_fwd(yb.data_ptr(), wb.data_ptr(), t.data_ptr(),
                                     logz.data_ptr(), gold.data_ptr(), R, wb.shape[0], D,
                                     yb.stride(0), wb.stride(0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_ce kernel launch failed with CUDA error {rc}")
    return logz, gold


# the backward kernel's limits: 256-column output slices, at most 768 columns
# (a 64-row operand tile in shared memory), at most 2048 tiles of 64 rows
BWD_SLICE, BWD_MAX_DIM, BWD_MAX_ROWS = 256, 768, 2048 * 64


def ce_bwd(y: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, wc: torch.Tensor,
           logz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy (R, D), dW (V, D)), both fp32, of sum_r wc_r (logz_r - gold_r):
    y and w in one dtype (bf16 on the card), targets (R,) ids, wc (R,) the
    row weights times the upstream gradient, logz (R,) from the forward.
    The kernel on CUDA, the plain version on the CPU."""
    _check(y, w, targets)
    if y.device.type == "cpu":
        return ce_bwd_reference(y, w, targets, wc, logz)
    if y.device.type != "cuda":
        raise RuntimeError(f"flash_ce runs on CUDA or CPU tensors, not {y.device}")
    out = _launch_bwd(y, w, targets, wc, logz)
    ce_bwd.launches += 1
    return out


ce_bwd.launches = 0


def _launch_bwd(y, w, targets, wc, logz):
    from egom2p_torch.ops import _build

    R, D = y.shape
    V = w.shape[0]
    if D % BWD_SLICE or D > BWD_MAX_DIM or R > BWD_MAX_ROWS:
        raise ValueError(f"the flash_ce backward kernel takes D a multiple of {BWD_SLICE} "
                         f"up to {BWD_MAX_DIM} and R <= {BWD_MAX_ROWS}, got R {R}, D {D}")
    yb, wb = _kernel_operand("y", y), _kernel_operand("w", w)
    t = targets.to(torch.int32).contiguous()
    wcc = wc.to(torch.float32).contiguous()
    lz = logz.to(torch.float32).contiguous()
    if wcc.shape != (R,) or lz.shape != (R,):
        raise ValueError(f"wc and logz must be ({R},), got {tuple(wcc.shape)}, {tuple(lz.shape)}")
    dy = torch.zeros((R, D), dtype=torch.float32, device=y.device)
    dw = torch.zeros((V, D), dtype=torch.float32, device=y.device)
    lib = _build.load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.egom2p_flash_ce_bwd(yb.data_ptr(), wb.data_ptr(), t.data_ptr(),
                                     wcc.data_ptr(), lz.data_ptr(), dy.data_ptr(),
                                     dw.data_ptr(), R, V, D, yb.stride(0), wb.stride(0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_ce backward kernel launch failed with CUDA error {rc}")
    return dy, dw


def ce_bwd_reference(y, w, targets, wc, logz, chunk: int = REF_CHUNK):
    """Plain version of the backward kernel: the chunked recompute, with dy
    kept in fp32."""
    _check(y, w, targets)
    return _bwd_chunked(y, w, targets, wc, logz, chunk, dy_f32=True)


def row_stats_reference(y: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                        chunk: int = REF_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: fp32 logits of y and w (both in
    y's dtype), chunk rows at a time."""
    _check(y, w, targets)
    wt = w.to(y.dtype).t()
    logz, gold = [], []
    for r0 in range(0, y.shape[0], chunk):
        logits = matmul_f32(y[r0:r0 + chunk], wt)
        logz.append(torch.logsumexp(logits, dim=-1))
        gold.append(logits.gather(1, targets[r0:r0 + chunk].long()[:, None])[:, 0])
    return torch.cat(logz), torch.cat(gold)


def flash_ce_total(y: torch.Tensor, w_mat: torch.Tensor, targets: torch.Tensor,
                   wts: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """sum(wts * cross_entropy(y @ w_mat.T, targets)), an fp32 scalar.

    y (R, D) activations, w_mat (V, D) head weight (cast to y's dtype for
    the products), targets (R,) ids already clamped into [0, V), wts (R,)
    row weights (0 for other modalities' rows)."""
    return _FlashCETotal.apply(y, w_mat, targets, wts.float(), chunk)


class _FlashCETotal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, w_mat, targets, wts, chunk):
        logz, gold = row_stats(y, w_mat.to(y.dtype), targets)
        ctx.save_for_backward(y, w_mat, targets, wts, logz)
        ctx.chunk = chunk
        return ((logz - gold) * wts).sum()

    @staticmethod
    def backward(ctx, g):
        y, w_mat, targets, wts, logz = ctx.saved_tensors
        if os.environ.get("EGOM2P_CE_PALLAS_BWD", "0") == "1":
            dy, dw = ce_bwd(y, w_mat.to(y.dtype), targets, wts * g, logz)
            return dy.to(y.dtype), dw.to(w_mat.dtype), None, None, None
        dy, dw = _bwd_chunked(y, w_mat.to(y.dtype), targets, wts * g, logz, ctx.chunk)
        return dy, dw.to(w_mat.dtype), None, None, None


def _bwd_chunked(y, w, targets, wc, logz, chunk: int, dy_f32: bool = False):
    """(dy in y's dtype, or fp32 with dy_f32, and dW fp32) of
    sum(wts * (logz - gold)); wc = wts * g."""
    R, D = y.shape
    V = w.shape[0]
    dy = torch.empty((R, D), dtype=torch.float32 if dy_f32 else y.dtype, device=y.device)
    dw = torch.zeros((V, D), dtype=torch.float32, device=y.device)
    wt = w.t()
    for r0 in range(0, R, chunk):
        y_c = y[r0:r0 + chunk]
        p = torch.exp(matmul_f32(y_c, wt) - logz[r0:r0 + chunk, None])
        p[torch.arange(p.shape[0], device=p.device), targets[r0:r0 + chunk].long()] -= 1.0
        dl = (p * wc[r0:r0 + chunk, None]).to(w.dtype)
        dy[r0:r0 + chunk] = matmul_f32(dl, w) if dy_f32 else torch.matmul(dl, w).to(y.dtype)
        dw += matmul_f32(dl.t(), y_c)
    return dy, dw
