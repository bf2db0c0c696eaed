"""Cross-entropy of the large-vocab heads without materialized logits.

`flash_ce_total(y, w_mat, targets, wts)` is the contract of
egom2p_tpu/ops/flash_ce.py: the sum over rows of wts * (logz - gold) for
logits = y @ w_mat.T, with w_mat cast to y's dtype for the products (bf16 in
training) and fp32 logits.  It is a torch.autograd.Function, differentiable
in y and w_mat; targets and wts get no gradient.

Both kernels take every model dim the JAX kernels take, any multiple of
128 (`takes_dim`, which the model's route to flash CE calls too).

Forward: `row_stats(y, w, targets, live=None)` -> (logz, gold) per row.  On
a CUDA tensor it launches the hand-written kernel csrc/flash_ce_fwd.cu
(wgmma on TMA-loaded chunks of y and W, an online logsumexp over vocab tiles;
the logits never reach device memory) or raises; on a CPU tensor it runs
`row_stats_reference`, the plain version.  `row_stats.launches` counts the
CUDA calls.  `live` (R,) bool marks the rows that count: a dead row gets
logz = +inf and gold = 0 on every route, and the kernel computes no 128-row
block whose rows are all dead.  `fwd_plan(D)` says how the kernel holds y
(streamed beside W in 64-column chunks, for every D), `fwd_splits(R, D, V,
n_sm)` into how many vocab slices it cuts the vocab so that the (row block,
slice) pairs fill the card; a combine pass folds the slices in a fixed
order.

Backward, by default: the chunked recompute of the JAX package's
`_bwd_chunked`, in plain PyTorch (the JAX package runs it in XLA, not in
Pallas): per chunk of rows, fp32 logits, p = exp(logits - logz),
dl = (p - onehot) * wts * g rounded to w's dtype, dy = dl @ w, dW += dl^T @ y
summed in fp32 and cast to w_mat's dtype.  With EGOM2P_CE_PALLAS_BWD=1 at
the time the backward runs, `ce_bwd(y, w, targets, wc, logz)` -> (dy, dW),
both fp32, computes the same in the hand-written kernel
csrc/flash_ce_bwd.cu (wgmma; a block owns 64 rows and the output
columns of one column group, `bwd_column_plan(D)`: all D columns up to
D = 768, so each logits tile is computed once, and above that groups of
512, 256 or 128 columns side by side in the grid, each recomputing its
logits tile; the logits never reach device memory; a CUDA tensor it cannot
take raises) or, on a CPU tensor, in `ce_bwd_reference`, the chunked
recompute with fp32 dy.  `ce_bwd.launches` counts its CUDA calls.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

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


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               bf16_values: Optional[bool] = None) -> torch.Tensor:
    """fp32 product a @ b with fp32 sums.

    A bf16 value is exact in TF32 (10 mantissa bits hold bf16's 7), so on a
    CUDA device the product of operands that hold bf16 values runs on the
    TF32 tensor cores with no rounding of its inputs: the same numbers as a
    full fp32 product, up to the order of the sums.  `bf16_values` says that
    both operands hold bf16 values, whatever their dtype (fp32 copies of
    bf16 tensors); by default it is true when both are bf16 tensors.  Other
    operands compute in full fp32.  Only this product takes TF32: the
    products of its backward run after the switch is restored."""
    if bf16_values is None:
        bf16_values = a.dtype == b.dtype == torch.bfloat16
    with _tf32_matmuls(a.is_cuda and bf16_values):
        return torch.matmul(a.float(), b.float())


# the kernels' column slices: a model dim is a whole number of them (the
# JAX kernels' 128-lane tiles)
DIM_STEP = 128
# the forward kernel (csrc/flash_ce_fwd.cu kRows, kCols): 128 rows of y a
# block and vocab tiles of 256 columns; vocab slices until the (row block,
# slice) pairs fill the SMs FWD_WAVES times, each slice at least
# FWD_MIN_SLICE_STEPS k-steps of 64 columns deep
FWD_ROWS = 128
FWD_COLS = 256
FWD_WAVES = 8
FWD_MIN_SLICE_STEPS = 24
# the backward kernel: all of D up to 768 columns (three warpgroups, each 256
# columns wide or, the last, 128) in one group; above, groups of 512, 256 or
# 128 columns, each recomputing the logits from a streamed owned tile
BWD_RESIDENT_MAX_DIM = 768
BWD_STREAM_GROUP_DIMS = (512, 256, 128)


def takes_dim(D: int) -> bool:
    """Whether the flash-CE kernels take model dim D: a positive multiple of
    128, as the JAX package's route asks.  The model's route to flash CE
    and both launchers decide by this function."""
    return D > 0 and D % DIM_STEP == 0


def _need_dim(D: int) -> None:
    if not takes_dim(D):
        raise ValueError(f"the flash_ce kernels take D a multiple of {DIM_STEP}, got {D}")


def fwd_plan(D: int) -> str:
    """How the forward kernel holds y: "streamed", 128 rows x 64 columns
    beside each 64-column chunk of W, for every D.  Raises where the kernel
    (and the JAX kernel) refuses D."""
    _need_dim(D)
    return "streamed"


def fwd_splits(R: int, D: int, V: int, n_sm: int) -> int:
    """The forward kernel's vocab slices S for R rows, model dim D, V vocab
    columns on a card of n_sm SMs: 1 once the 128-row blocks alone fill the
    SMs FWD_WAVES times; else enough slices for the (row block, slice) pairs
    to do so, each slice a whole number of FWD_COLS-column tiles and at least
    FWD_MIN_SLICE_STEPS k-steps (tiles x D / 64) deep where V allows, none
    empty.  Slice s holds tiles s * ceil(tiles / S) onwards."""
    _need_dim(D)
    if R <= 0 or V <= 0 or n_sm <= 0:
        raise ValueError(f"fwd_splits takes positive R, V and n_sm, got {R}, {V}, {n_sm}")
    blocks = -(-R // FWD_ROWS)
    tiles = -(-V // FWD_COLS)
    want = -(-FWD_WAVES * n_sm // blocks)  # slices for the pairs to fill the card
    min_tiles = -(-FWD_MIN_SLICE_STEPS // (D // 64))
    per = min(tiles, max(min_tiles, -(-tiles // want)))  # tiles a slice
    return -(-tiles // per)


def bwd_column_plan(D: int) -> Tuple[Tuple[int, ...], ...]:
    """The backward kernel's column groups for model dim D, each the tuple
    of its warpgroups' widths (256, and 128 for a remainder): one group of
    all D columns up to 768, else the fewest equal groups of a width in
    BWD_STREAM_GROUP_DIMS, each a grid column of blocks that recompute their
    logits tile.  Raises where the kernel (and the JAX kernel) refuses D."""
    _need_dim(D)
    width = D if D <= BWD_RESIDENT_MAX_DIM else next(
        w for w in BWD_STREAM_GROUP_DIMS if D % w == 0)
    group = (256,) * (width // 256) + ((128,) if width % 256 else ())
    return (group,) * (D // width)


def _check(y, w, targets):
    if y.dim() != 2 or w.dim() != 2 or y.shape[1] != w.shape[1]:
        raise ValueError(f"flash_ce takes y (R, D) and w (V, D), got {tuple(y.shape)}, "
                         f"{tuple(w.shape)}")
    if tuple(targets.shape) != (y.shape[0],):
        raise ValueError(f"targets must be (R,) = ({y.shape[0]},), got {tuple(targets.shape)}")
    if not takes_dim(y.shape[1]):
        raise ValueError(f"flash_ce needs the model dim to be a multiple of 128, got {y.shape[1]}")
    for name, t in (("w", w), ("targets", targets)):
        if t.device != y.device:
            raise ValueError(f"flash_ce {name} is on {t.device}, y on {y.device}")


def _check_live(y, live):
    if live is not None and (tuple(live.shape) != (y.shape[0],) or live.device != y.device):
        raise ValueError(f"live must be ({y.shape[0]},) on {y.device}, got "
                         f"{tuple(live.shape)} on {live.device}")


def row_stats(y: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
              live: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logz, gold), two fp32 (R,) vectors, of the logits y @ w.T; w has
    y's dtype.  live (R,) bool, or None for every row: a dead row gets logz
    = +inf and gold = 0.  The kernel on CUDA, the plain version on the CPU."""
    _check(y, w, targets)
    _check_live(y, live)
    if y.device.type == "cpu":
        return row_stats_reference(y, w, targets, live=live)
    if y.device.type != "cuda":
        raise RuntimeError(f"flash_ce runs on CUDA or CPU tensors, not {y.device}")
    out = _launch(y, w, targets, live)
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


def _launch(y, w, targets, live):
    from egom2p_torch.ops import _build

    R, D = y.shape
    V = w.shape[0]
    fwd_plan(D)  # raises on a D the kernel does not take
    yb, wb = _kernel_operand("y", y), _kernel_operand("w", w)
    t = targets.to(torch.int32).contiguous()
    mark = None if live is None else live.to(torch.uint8).contiguous()
    splits = fwd_splits(R, D, V, torch.cuda.get_device_properties(y.device).multi_processor_count)
    logz = torch.empty(R, dtype=torch.float32, device=y.device)
    gold = torch.empty(R, dtype=torch.float32, device=y.device)
    # the slices' partial (max, sum, gold) per row, and the scan's list of
    # the 128-row blocks that hold a live row with their count
    partial = torch.empty(3 * splits * R, dtype=torch.float32, device=y.device)
    scratch = torch.empty(-(-R // FWD_ROWS) + 1, dtype=torch.int32, device=y.device)
    lib = _build.load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.egom2p_flash_ce_fwd(yb.data_ptr(), wb.data_ptr(), t.data_ptr(),
                                     None if mark is None else mark.data_ptr(),
                                     logz.data_ptr(), gold.data_ptr(), partial.data_ptr(),
                                     scratch.data_ptr(), R, V, D, splits,
                                     yb.stride(0), wb.stride(0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_ce kernel launch failed with CUDA error {rc}")
    return logz, gold


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
    group_dim = sum(bwd_column_plan(D)[0])  # raises on a D the kernel does not take
    yb, wb = _kernel_operand("y", y), _kernel_operand("w", w)
    t = targets.to(torch.int32).contiguous()
    wcc = wc.to(torch.float32).contiguous()
    lz = logz.to(torch.float32).contiguous()
    if wcc.shape != (R,) or lz.shape != (R,):
        raise ValueError(f"wc and logz must be ({R},), got {tuple(wcc.shape)}, {tuple(lz.shape)}")
    dy = torch.zeros((R, D), dtype=torch.float32, device=y.device)
    dw = torch.zeros((V, D), dtype=torch.float32, device=y.device)
    # the kernel's list of the 32-row tiles and 64-row blocks of y that count
    scratch = torch.empty(-(-R // 32) + -(-R // 64) + 2, dtype=torch.int32, device=y.device)
    lib = _build.load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.egom2p_flash_ce_bwd(yb.data_ptr(), wb.data_ptr(), t.data_ptr(),
                                     wcc.data_ptr(), lz.data_ptr(), dy.data_ptr(),
                                     dw.data_ptr(), scratch.data_ptr(), R, V, D, group_dim,
                                     yb.stride(0), wb.stride(0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_ce backward kernel launch failed with CUDA error {rc}")
    return dy, dw


def ce_bwd_reference(y, w, targets, wc, logz, chunk: int = REF_CHUNK):
    """Plain version of the backward kernel: the chunked recompute, with dy
    kept in fp32."""
    _check(y, w, targets)
    return _bwd_chunked(y, w, targets, wc, logz, chunk, dy_f32=True)


def row_stats_reference(y: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                        chunk: int = REF_CHUNK, live: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: fp32 logits of y and w (both in
    y's dtype), chunk rows at a time; rows where `live` is False get logz =
    +inf and gold = 0."""
    _check(y, w, targets)
    _check_live(y, live)
    wt = w.to(y.dtype).t()
    logz, gold = [], []
    for r0 in range(0, y.shape[0], chunk):
        logits = matmul_f32(y[r0:r0 + chunk], wt)
        logz.append(torch.logsumexp(logits, dim=-1))
        gold.append(logits.gather(1, targets[r0:r0 + chunk].long()[:, None])[:, 0])
    logz, gold = torch.cat(logz), torch.cat(gold)
    if live is not None:
        logz = torch.where(live, logz, torch.inf)
        gold = torch.where(live, gold, 0.0)
    return logz, gold


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
        # rows of weight 0 are not computed: logz = +inf, gold = 0 there, so
        # both backwards see p = exp(s - inf) = 0 and dl = 0 on them
        live = wts != 0
        logz, gold = row_stats(y, w_mat.to(y.dtype), targets, live=live)
        ctx.save_for_backward(y, w_mat, targets, wts, logz)
        ctx.chunk = chunk
        return (torch.where(live, logz - gold, 0.0) * wts).sum()

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
