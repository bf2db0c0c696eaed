"""3D Haar wavelet patching for the Cosmos video tokenizer (encode side).

Port of `dwt3d` / `patch3d_haar` from egom2p_tpu/ops/wavelet.py (reference:
cosmos_tokenizer/modules/patching.py:112-356).  For even-length axes the
reference's stride-2 Haar convs with the global 1/(2*sqrt(2)) rescale reduce
to l = (x0 + x1) / 2, h = (x0 - x1) / 2 per axis, applied along T, H, W in
that order, with subband-major channel stacking [8 subbands x C].

Layout is channels-last (B, T, H, W, C), as in the JAX package.
"""
from __future__ import annotations

import torch


def _axis_dwt(x: torch.Tensor, axis: int):
    n = x.shape[axis]
    if n % 2:
        raise ValueError(f"axis {axis} length {n} must be even for the Haar DWT")
    xr = x.unflatten(axis, (n // 2, 2))
    x0, x1 = xr.select(axis + 1, 0), xr.select(axis + 1, 1)
    return (x0 + x1) * 0.5, (x0 - x1) * 0.5


def dwt3d(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T/2, H/2, W/2, 8*C), subband-major channels."""
    lt, ht = _axis_dwt(x, 1)
    bands = []
    for tb in (lt, ht):
        lh, hh = _axis_dwt(tb, 2)
        for hb in (lh, hh):
            bands.extend(_axis_dwt(hb, 3))
    return torch.cat(bands, dim=-1)


def patch3d_haar(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Causal 3D Haar patching: the first frame is repeated `patch_size`
    times so a 1+(T-1) causal clip maps to (T-1+patch)/patch latent frames
    (reference: patching.py:161-166)."""
    x = torch.cat([x[:, :1].expand(-1, patch_size, -1, -1, -1), x[:, 1:]], dim=1)
    for _ in range(int(patch_size).bit_length() - 1):
        x = dwt3d(x)
    return x
