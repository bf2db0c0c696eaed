"""Finite Scalar Quantization (FSQ), inference side.

Port of `FSQ` from egom2p_tpu/ops/fsq.py (reference:
cosmos_tokenizer/modules/quantizers.py:71-227; arXiv 2309.15505).  The DV4x8x8
video tokenizer uses levels (8,8,8,5,5,5): an implicit codebook of 64,000
entries over 6 channels.  All math is fp32, rounding is half-to-even
(torch.round, as jnp.round), and indices are an fp32 mixed-radix sum
truncated to int32, as in the JAX package.
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
        # the straight-through form of the JAX package, bounded + (rounded -
        # bounded), which equals `rounded` exactly in fp32
        quantized = bounded + (torch.round(bounded) - bounded)
        return quantized / self._const(self.levels // 2, z)

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        """normalized codes (..., dim) -> int32 indices (...)."""
        half_width = self._const(self.levels // 2, zhat)
        shifted = zhat * half_width + half_width  # in [0, levels - 1]
        return (shifted * self._const(self.basis, zhat)).sum(dim=-1).to(torch.int32)

    def __call__(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z: (..., dim) -> (indices (...), codes (..., dim))."""
        codes = self.quantize(z)
        return self.codes_to_indices(codes), codes
