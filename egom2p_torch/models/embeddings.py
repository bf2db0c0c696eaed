"""Per-modality token-grid embeddings (video tokens, gaze/cam tokens).

Port of the token-grid part of egom2p_tpu/models/embeddings.py (reference:
egom2p/models/encoder_embeddings.py, decoder_embeddings.py).  Each module owns
its `token_emb` table and its modality embedding `mod_emb`, as the reference
does; EgoM2P ties the decoder's `mod_emb` to the encoder's for shared
modalities (reference: egom2p_model.py:179-183).  The decoder head is tied to
`token_emb` (reference: decoder_embeddings.py:89-91); an untied `to_logits`
head is not ported.

Modules return
  x   : (B, L, D) value embedding, in the compute dtype,
  emb : (B, L, D) positional + modality embedding, in the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from egom2p_torch.ops.flash_ce import matmul_f32
from egom2p_torch.ops.posemb import (build_1d_sincos_posemb,
                                     build_2d_sincos_posemb,
                                     build_3d_sincos_posemb)


def _grid_posemb(grid: Tuple[int, ...], dim: int):
    if len(grid) == 1:
        return build_1d_sincos_posemb(grid[0], dim)
    if len(grid) == 2:
        return build_2d_sincos_posemb(grid[0], grid[1], dim)
    return build_3d_sincos_posemb(grid[0], grid[1], grid[2], dim)


class _TokenGridEmbedding(nn.Module):
    def __init__(self, vocab_size: int, grid: Tuple[int, ...], dim: int):
        super().__init__()
        self.vocab_size = vocab_size
        self.grid = tuple(grid)
        self.token_emb = nn.Embedding(vocab_size, dim)
        self.mod_emb = nn.Parameter(torch.zeros(1, 1, dim))
        self.register_buffer("pos_emb", torch.from_numpy(_grid_posemb(self.grid, dim)),
                             persistent=False)

    def positional(self, batch: int, compute_dtype) -> torch.Tensor:
        """(B, L, D) positional + modality embedding (summed in fp32)."""
        emb = (self.pos_emb + self.mod_emb).to(compute_dtype)
        return emb.expand(batch, -1, -1)

    def _values(self, d: Dict[str, torch.Tensor], compute_dtype):
        ids = d["tensor"].reshape(d["tensor"].shape[0], -1)
        return ids, self.token_emb(ids).to(compute_dtype)


class TokenGridEncoderEmbedding(_TokenGridEmbedding):
    """Video / gaze-cam token encoder embedding with a fixed positional grid
    (reference: encoder_embeddings.py:124-302)."""

    def forward(self, d: Dict[str, torch.Tensor], compute_dtype=torch.bfloat16):
        ids, x = self._values(d, compute_dtype)
        return x, self.positional(ids.shape[0], compute_dtype)


class TokenGridDecoderEmbedding(_TokenGridEmbedding):
    """Decoder-side token embedding + logits head for grid modalities
    (reference: decoder_embeddings.py:156-501)."""

    def forward_embed(self, d: Dict[str, torch.Tensor], compute_dtype=torch.bfloat16):
        ids, x = self._values(d, compute_dtype)
        return x, self.positional(ids.shape[0], compute_dtype), ids

    def head_weight(self, dtype) -> torch.Tensor:
        """The (V, D) head matrix rounded to `dtype` and held in fp32: the
        JAX einsum's inputs, for an fp32-accumulated product."""
        return self.token_emb.weight.to(dtype).float()

    def forward_logits(self, y: torch.Tensor, head_weight=None) -> torch.Tensor:
        """fp32 logits (..., V) of y (..., D): bf16 operands, fp32 products
        and sums, as the JAX einsum with preferred_element_type=fp32.
        `head_weight` lets a caller that loops over chunks pass
        `head_weight(y.dtype)` once.  Under bf16 compute both operands hold
        bf16 values, which TF32 represents exactly: on the card the product
        runs on the TF32 tensor cores (flash_ce.matmul_f32) with the numbers
        of the full fp32 product, up to the order of the sums."""
        w = self.head_weight(y.dtype) if head_weight is None else head_weight
        return matmul_f32(y, w.t(), bf16_values=y.dtype == torch.bfloat16)


def _grid_of(spec: Dict) -> Tuple[int, ...]:
    kind = spec["kind"]
    if kind in ("video_token", "image_token"):
        return tuple(spec["grid"])
    if kind == "gazecam_token":
        return (spec["length"],)
    raise NotImplementedError(
        f"embedding kind {kind!r} is not ported yet (token grids only)")


def make_encoder_embedding(spec: Dict, dim: int) -> TokenGridEncoderEmbedding:
    return TokenGridEncoderEmbedding(spec["vocab_size"], _grid_of(spec), dim)


def make_decoder_embedding(spec: Dict, dim: int) -> TokenGridDecoderEmbedding:
    return TokenGridDecoderEmbedding(spec["vocab_size"], _grid_of(spec), dim)
