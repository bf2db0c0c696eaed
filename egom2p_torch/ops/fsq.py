"""Finite Scalar Quantization (FSQ) and its residual and lookup-free
relatives: quantize and index in the encoder, indices back to codes in the
decoder.

Port of `FSQ`, `ResidualFSQ` and `LFQ` from egom2p_tpu/ops/fsq.py
(reference: cosmos_tokenizer/modules/quantizers.py:36-227, 392-534; arXiv
2309.15505).  The DV4x8x8 video tokenizer uses levels (8,8,8,5,5,5): an
implicit codebook of 64,000 entries over 6 channels.  All math is fp32,
rounding is half-to-even (torch.round, as jnp.round), and FSQ's indices are
an fp32 mixed-radix sum truncated to int32, as in the JAX package.  The
quantizers pass gradients straight through.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


class FSQ:
    def __init__(self, levels: Sequence[int] = (8, 8, 8, 5, 5, 5)):
        self.levels = np.asarray(levels, dtype=np.int32)
        self.dim = len(levels)
        # mixed-radix basis (reference: quantizers.py:96-99)
        self.basis = np.concatenate([[1], np.cumprod(self.levels[:-1])]).astype(np.int32)
        self.codebook_size = int(np.prod(self.levels))

    def _const(self, arr, z: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.float32), device=z.device)

    def bound(self, z: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
        """(reference: quantizers.py:136-141)"""
        levels = self._const(self.levels, z)
        half_l = (levels - 1) * (1 + eps) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        shift = torch.atanh(offset / half_l)
        return torch.tanh(z + shift) * half_l - offset

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """z: (..., dim) -> normalized codes in [-1, 1]
        (reference: quantizers.py:143-147)."""
        bounded = self.bound(z.float())
        # the straight-through form of the JAX package, bounded + sg(rounded -
        # bounded), which equals `rounded` exactly in fp32
        quantized = bounded + (torch.round(bounded) - bounded).detach()
        return quantized / self._const(self.levels // 2, z)

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        """normalized codes (..., dim) -> int32 indices (...)."""
        half_width = self._const(self.levels // 2, zhat)
        shifted = zhat * half_width + half_width  # in [0, levels - 1]
        return (shifted * self._const(self.basis, zhat)).sum(dim=-1).to(torch.int32)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """int indices (...) -> normalized codes (..., dim), fp32."""
        idx = indices.to(torch.int64)[..., None]
        basis = torch.as_tensor(self.basis.astype(np.int64), device=indices.device)
        levels = torch.as_tensor(self.levels.astype(np.int64), device=indices.device)
        half_width = self._const(self.levels // 2, indices)
        return (torch.div(idx, basis, rounding_mode="floor") % levels - half_width) / half_width

    def __call__(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z: (..., dim) -> (indices (...), codes (..., dim))."""
        codes = self.quantize(z)
        return self.codes_to_indices(codes), codes


class ResidualFSQ:
    """Residual FSQ stack (reference: quantizers.py:36-68, arXiv 2107.03312
    Algorithm 1): each stage quantizes the previous stage's residual."""

    def __init__(self, levels: Sequence[int] = (8, 8, 8, 5, 5, 5), num_quantizers: int = 4):
        self.layers = [FSQ(levels) for _ in range(num_quantizers)]
        self.num_quantizers = num_quantizers

    def __call__(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z: (B, ..., dim) -> (indices (B, num_quantizers, ...), codes)."""
        residual = z.float()
        out = torch.zeros_like(residual)
        indices = []
        for layer in self.layers:
            idx, codes = layer(residual)
            indices.append(idx)
            residual = residual - codes.detach()
            out = out + codes
        return torch.stack(indices, dim=1), out

    def indices_to_codes(self, indices_stack: torch.Tensor) -> torch.Tensor:
        """indices_stack: (B, num_quantizers, ...) -> the summed codes."""
        out = 0
        for i, layer in enumerate(self.layers):
            out = out + layer.indices_to_codes(indices_stack[:, i])
        return out


class LFQ:
    """Lookup-free (sign) quantization (reference: quantizers.py:392-534,
    MagViT2): each latent channel quantizes to +-1 and the index is the
    sign bits' pattern.  The entropy and commitment losses are the caller's."""

    def __init__(self, codebook_dim: int):
        self.dim = codebook_dim
        self.codebook_size = 2 ** codebook_dim
        self.basis = (2 ** np.arange(codebook_dim)).astype(np.int64)

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        q = torch.where(z > 0, 1.0, -1.0).to(z.dtype)
        return z + (q - z).detach()

    def codes_to_indices(self, codes: torch.Tensor) -> torch.Tensor:
        bits = (codes > 0).to(torch.int32)
        basis = torch.as_tensor(self.basis.astype(np.int32), device=codes.device)
        return (bits * basis).sum(dim=-1, dtype=torch.int32)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        basis = torch.as_tensor(self.basis, device=indices.device)
        bits = torch.div(indices.to(torch.int64)[..., None], basis, rounding_mode="floor") % 2
        return bits.float() * 2.0 - 1.0

    def __call__(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z: (..., codebook_dim) -> (indices (...) int32, codes (..., codebook_dim))."""
        codes = self.quantize(z.float())
        return self.codes_to_indices(codes), codes
