"""Haar wavelet and rearrange patching and unpatching for the Cosmos
tokenizers.

Port of egom2p_tpu/ops/wavelet.py (reference: cosmos_tokenizer/modules/
patching.py:39-356): the 3-D Haar patcher of the video tokenizers
(`dwt3d` / `patch3d_haar` and their inverses), the per-frame 2-D Haar
patcher of the BASE video network and the image tokenizers (`dwt2d` /
`patch2d_haar`: W first, then H, subbands [ll, lh, hl, hh] W-major), and
the space-to-depth `rearrange` patchers in 2-D and 3-D.  For even-length
axes the reference's stride-2 Haar convs with the global 1/(2*sqrt(2))
rescale reduce to l = (x0 + x1) / 2, h = (x0 - x1) / 2 per axis (inverse:
x0 = l + h, x1 = l - h), applied along T, H, W in that order, with
subband-major channel stacking [8 subbands x C].

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


def _axis_idwt(lo: torch.Tensor, hi: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.stack([lo + hi, lo - hi], dim=axis + 1).flatten(axis, axis + 1)


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


def idwt3d(x: torch.Tensor) -> torch.Tensor:
    """Inverse of dwt3d: (B, T, H, W, 8*C) -> (B, 2T, 2H, 2W, C)."""
    bands = x.chunk(8, dim=-1)
    t_parts = []
    for tb in range(2):
        h_parts = [_axis_idwt(bands[tb * 4 + hb * 2], bands[tb * 4 + hb * 2 + 1], 3)
                   for hb in range(2)]
        t_parts.append(_axis_idwt(h_parts[0], h_parts[1], 2))
    return _axis_idwt(t_parts[0], t_parts[1], 1)


def unpatch3d_haar(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Inverse patching; drops the (patch_size - 1) repeated lead frames
    (reference: patching.py:341-345)."""
    for _ in range(int(patch_size).bit_length() - 1):
        x = idwt3d(x)
    return x[:, patch_size - 1:]


def dwt2d(x: torch.Tensor) -> torch.Tensor:
    """Per-frame spatial Haar DWT: (B, T, H, W, C) -> (B, T, H/2, W/2, 4*C),
    subband-major, W first (reference: patching.py:84-92)."""
    bands = []
    for wb in _axis_dwt(x, 3):
        bands.extend(_axis_dwt(wb, 2))
    return torch.cat(bands, dim=-1)


def idwt2d(x: torch.Tensor) -> torch.Tensor:
    """Inverse of dwt2d."""
    bands = x.chunk(4, dim=-1)
    return _axis_idwt(_axis_idwt(bands[0], bands[1], 2), _axis_idwt(bands[2], bands[3], 2), 3)


def patch2d_haar(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Per-frame spatial Haar patching (the BASE encoder's patcher,
    reference: layers3d.py:558-562)."""
    for _ in range(int(patch_size).bit_length() - 1):
        x = dwt2d(x)
    return x


def unpatch2d_haar(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    for _ in range(int(patch_size).bit_length() - 1):
        x = idwt2d(x)
    return x


def patch2d_rearrange(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Per-frame space-to-depth (reference: patching.py:102-109):
    (B, T, H, W, C) -> (B, T, H/p, W/p, C*p*p)."""
    b, t, h, w, c = x.shape
    p = patch_size
    x = x.reshape(b, t, h // p, p, w // p, p, c).permute(0, 1, 2, 4, 6, 3, 5)
    return x.reshape(b, t, h // p, w // p, c * p * p)


def unpatch2d_rearrange(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    b, t, h, w, cp = x.shape
    p = patch_size
    x = x.reshape(b, t, h, w, cp // (p * p), p, p).permute(0, 1, 2, 5, 3, 6, 4)
    return x.reshape(b, t, h * p, w * p, cp // (p * p))


def patch3d_rearrange(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """The causal patch_method='rearrange' variant (reference:
    patching.py:168-178): the first frame repeated `patch_size` times, then
    'b (t p1) (h p2) (w p3) c -> b t h w (c p1 p2 p3)'."""
    p = patch_size
    x = torch.cat([x[:, :1].expand(-1, p, -1, -1, -1), x[:, 1:]], dim=1)
    b, t, h, w, c = x.shape
    x = x.reshape(b, t // p, p, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, t // p, h // p, w // p, c * p ** 3)


def unpatch3d_rearrange(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    b, t, h, w, cp = x.shape
    p = patch_size
    x = x.reshape(b, t, h, w, cp // p ** 3, p, p, p).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, t * p, h * p, w * p, cp // p ** 3)[:, p - 1:]
