"""Per-modality embeddings: token grids (video, gaze / cam tokens), token
sequences (captions) and precomputed sequence embeddings (T5 / CLIP text).

Port of egom2p_tpu/models/embeddings.py (reference:
egom2p/models/encoder_embeddings.py, decoder_embeddings.py).  Each module owns
its `token_emb` table and its modality embedding `mod_emb`, as the reference
does; EgoM2P ties the decoder's `mod_emb` to the encoder's for shared
modalities (reference: egom2p_model.py:179-183) unless the config unshares
them.  The decoder head is tied to `token_emb` (reference:
decoder_embeddings.py:89-91) unless the modality's embed spec says
`share_embedding: False`: then it is its own `to_logits` (V, D) matrix, as
the JAX package's share_embedding=False (the reference's untied
`to_logits` Linear).
Raw pixels (`image_raw`: rgb@224, rgb@448) enter through a bias-free patch
projection (ImagePatchEncoderEmbedding).

A sequence's positions are the running count of its visible slots: the
n-th visible slot (input slots in the encoder, target slots in the
decoder) takes sincos position n - 1 of a 512-row table cut to
`max_length`, and a [PAD] token (`padding_idx`) embeds to zero.

Modules return
  x   : (B, L, D) value embedding, in the compute dtype,
  emb : (B, L, D) positional + modality embedding, in the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from egom2p_torch.models.transformer import Linear
from egom2p_torch.ops.flash_ce import matmul_f32
from egom2p_torch.ops.posemb import (build_1d_sincos_posemb,
                                     build_2d_sincos_posemb,
                                     build_3d_sincos_posemb)

MAX_SINCOS_POS_EMB = 512


def _grid_posemb(grid: Tuple[int, ...], dim: int):
    if len(grid) == 1:
        return build_1d_sincos_posemb(grid[0], dim)
    if len(grid) == 2:
        return build_2d_sincos_posemb(grid[0], grid[1], dim)
    return build_3d_sincos_posemb(grid[0], grid[1], grid[2], dim)


class _Head:
    """The vocab head: `token_emb` (tied) or `to_logits` (untied)."""

    def _init_head(self, vocab_size: int, dim: int, share_embedding: bool) -> None:
        self.share_embedding = share_embedding
        if not share_embedding:
            self.to_logits = nn.Linear(dim, vocab_size, bias=False)

    @property
    def logits_weight(self) -> torch.Tensor:
        """The (V, D) head matrix (the parameter itself)."""
        return self.token_emb.weight if self.share_embedding else self.to_logits.weight

    def head_weight(self, dtype) -> torch.Tensor:
        """The (V, D) head matrix rounded to `dtype` and held in fp32: the
        JAX einsum's inputs, for an fp32-accumulated product."""
        return self.logits_weight.to(dtype).float()

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


class TokenGridDecoderEmbedding(_Head, _TokenGridEmbedding):
    """Decoder-side token embedding + logits head for grid modalities
    (reference: decoder_embeddings.py:156-501)."""

    def __init__(self, vocab_size: int, grid: Tuple[int, ...], dim: int,
                 share_embedding: bool = True):
        super().__init__(vocab_size, grid, dim)
        self._init_head(vocab_size, dim, share_embedding)

    def forward_embed(self, d: Dict[str, torch.Tensor], compute_dtype=torch.bfloat16):
        ids, x = self._values(d, compute_dtype)
        return x, self.positional(ids.shape[0], compute_dtype), ids


class _SequencePositions(nn.Module):
    """The 1-D sincos table of a sequence modality and its modality
    embedding."""

    def __init__(self, max_length: int, dim: int):
        super().__init__()
        self.max_length = max_length
        self.mod_emb = nn.Parameter(torch.zeros(1, 1, dim))
        pos = build_1d_sincos_posemb(MAX_SINCOS_POS_EMB, dim)[:, :max_length]
        self.register_buffer("pos_emb", torch.from_numpy(pos), persistent=False)

    def positions(self, hidden: torch.Tensor, compute_dtype, over_length_to_zero: bool):
        """(B, L, D) positional + modality embedding: the running count of
        the visible slots (`hidden` False) indexes the table; hidden slots
        take no position.  Counts past the table are clipped to its last row
        (encoder) or sent to row 0 (decoder: such targets are cut later)."""
        pos_id = torch.cumsum((~hidden).int(), dim=1) - 1
        pos_id = pos_id.masked_fill(hidden, 0)
        if over_length_to_zero:
            pos_id = pos_id.masked_fill(pos_id >= self.max_length, 0)
        else:
            pos_id = pos_id.clamp(0, self.max_length - 1)
        pos = self.pos_emb[0][pos_id.long()].masked_fill(hidden[..., None], 0.0)
        return (pos + self.mod_emb).to(compute_dtype)


class _SequenceEmbedding(_SequencePositions):
    def __init__(self, vocab_size: int, max_length: int, dim: int, padding_idx: int = 0):
        super().__init__(max_length, dim)
        self.vocab_size = vocab_size
        self.padding_idx = padding_idx
        self.token_emb = nn.Embedding(vocab_size, dim)

    def _values(self, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
        """Token embeddings, zero where the id is `padding_idx`."""
        x = self.token_emb(ids).masked_fill((ids == self.padding_idx)[..., None], 0.0)
        return x.to(compute_dtype)


class SequenceEncoderEmbedding(_SequenceEmbedding):
    """Caption / detection encoder embedding with cumsum positions
    (reference: encoder_embeddings.py:23-122)."""

    def forward(self, d: Dict[str, torch.Tensor], compute_dtype=torch.bfloat16):
        return (self._values(d["tensor"], compute_dtype),
                self.positions(d["input_mask"].bool(), compute_dtype, False))


class SequenceDecoderEmbedding(_Head, _SequenceEmbedding):
    """Decoder-side sequence embedding + logits head
    (reference: decoder_embeddings.py:24-152)."""

    def __init__(self, vocab_size: int, max_length: int, dim: int, padding_idx: int = 0,
                 share_embedding: bool = True):
        super().__init__(vocab_size, max_length, dim, padding_idx)
        self._init_head(vocab_size, dim, share_embedding)

    def forward_embed(self, d: Dict[str, torch.Tensor], compute_dtype=torch.bfloat16):
        ids = d["tensor"]
        return (self._values(ids, compute_dtype),
                self.positions(d["target_mask"].bool(), compute_dtype, True), ids)


class SequenceEmbEncoderEmbedding(_SequencePositions):
    """Precomputed sequence embeddings (T5-XXL / CLIP text) projected to the
    model width by `emb_proj`, a Linear or a bottleneck pair (the
    reference's Sequential: keys emb_proj.0 / emb_proj.1), with cumsum
    positions; input only (reference: encoder_embeddings.py:493-602)."""

    def __init__(self, max_length: int, orig_emb_dim: int, dim: int,
                 use_bottleneck: bool = False, bottleneck_dim: int = 64):
        super().__init__(max_length, dim)
        if use_bottleneck:
            self.emb_proj = nn.Sequential(Linear(orig_emb_dim, bottleneck_dim),
                                          Linear(bottleneck_dim, dim))
        else:
            self.emb_proj = Linear(orig_emb_dim, dim)

    def forward(self, d: Dict[str, torch.Tensor], compute_dtype=torch.bfloat16):
        x = self.emb_proj(d["tensor"].to(compute_dtype))
        return x, self.positions(d["input_mask"].bool(), compute_dtype, False)


class ImagePatchEncoderEmbedding(nn.Module):
    """Raw-pixel patch projection (reference: encoder_embeddings.py:395-492;
    egom2p_tpu/models/embeddings.py:ImagePatchEncoderEmbedding): (B, H, W,
    C) channel-last pixels -> (B, H/p * W/p, D) by a bias-free product over
    each patch's pixels in (ph, pw, C) order (the reference's '(ph pw d)'
    rearrange, so converted weights line up), with the 2-D sincos posemb
    of the configured image size plus the modality embedding; the input
    mask is per patch."""

    def __init__(self, num_channels: int, patch_size: int, image_size: int, dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Linear(patch_size * patch_size * num_channels, dim, bias=False)
        self.mod_emb = nn.Parameter(torch.zeros(1, 1, dim))
        g = image_size // patch_size
        self.register_buffer("pos_emb", torch.from_numpy(build_2d_sincos_posemb(g, g, dim)),
                             persistent=False)

    def forward(self, d: Dict[str, torch.Tensor], compute_dtype=torch.bfloat16):
        x = d["tensor"]
        B, H, W, C = x.shape
        p = self.patch_size
        x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        x = self.proj(x.reshape(B, (H // p) * (W // p), p * p * C).to(compute_dtype))
        emb = (self.pos_emb + self.mod_emb).to(compute_dtype).expand(B, -1, -1)
        return x, emb


def _grid_of(spec: Dict) -> Tuple[int, ...]:
    if spec["kind"] in ("video_token", "image_token"):
        return tuple(spec["grid"])
    return (spec["length"],)  # gazecam_token


def make_encoder_embedding(spec: Dict, dim: int) -> nn.Module:
    kind = spec["kind"]
    if kind in ("video_token", "image_token", "gazecam_token"):
        return TokenGridEncoderEmbedding(spec["vocab_size"], _grid_of(spec), dim)
    if kind == "sequence":
        return SequenceEncoderEmbedding(spec["vocab_size"], spec["max_length"], dim,
                                        spec.get("padding_idx", 0))
    if kind == "sequence_emb":
        return SequenceEmbEncoderEmbedding(spec["max_length"], spec.get("orig_emb_dim", 4096),
                                           dim, spec.get("use_bottleneck", False),
                                           spec.get("bottleneck_dim", 64))
    if kind == "image_raw":
        return ImagePatchEncoderEmbedding(spec.get("num_channels", 3), spec["patch_size"],
                                          spec["image_size"], dim)
    raise ValueError(f"embedding kind {kind!r}")


def make_decoder_embedding(spec: Dict, dim: int) -> nn.Module:
    kind = spec["kind"]
    share = spec.get("share_embedding", True)
    if kind in ("video_token", "image_token", "gazecam_token"):
        return TokenGridDecoderEmbedding(spec["vocab_size"], _grid_of(spec), dim, share)
    if kind == "sequence":
        return SequenceDecoderEmbedding(spec["vocab_size"], spec["max_length"], dim,
                                        spec.get("padding_idx", 0), share)
    raise ValueError(f"no decoder embedding for kind {kind!r}")
