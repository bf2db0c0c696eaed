"""Vector-quantization codebook lookup (the inference half).

Port of the lookup part of egom2p_tpu/ops/vq.py (reference:
egom2p/vq/quantizers/quantize_lucid.py:181-428, 499-506): the codebook state,
its kaiming-uniform init (l2-normalised for the cosine-sim codebook), the
nearest-code lookup and the index -> code-row lookup of decode_tokens.  The
main model's cam and gaze tokenizers use the cosine-sim form (the reference's
norm_codes=True, egom2p/vq/vqvae.py:171-185); the euclidean form is here too.

The lookup computes in fp32.  The EMA codebook updates (and the state they
keep), kmeans init, dead-code expiry and the codebook sync across devices are
training and are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class VQState:
    embed: torch.Tensor          # (K, D) codebook
    cluster_size: torch.Tensor   # (K,) EMA usage counts
    initted: torch.Tensor        # one element: False until a kmeans init ran


@dataclasses.dataclass(frozen=True)
class VQConfig:
    """The lookup's part of egom2p_tpu.ops.vq.VQConfig; the EMA update's
    fields (decay, eps, dead-code threshold and policy, commitment weight,
    norm_latents) come with the training port."""
    codebook_size: int = 256
    dim: int = 32
    use_cosine_sim: bool = True


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=eps)


def init_vq_state(cfg: VQConfig, generator: torch.Generator, device=None) -> VQState:
    """A fresh codebook drawn from `generator`: kaiming-uniform like the
    reference's uniform_init (quantize_lucid.py:41-44), l2-normalised for
    the cosine-sim codebook.  The kmeans init is training and not ported."""
    device = generator.device if device is None else torch.device(device)
    bound = math.sqrt(3.0) * math.sqrt(2.0 / cfg.dim)
    embed = torch.rand((cfg.codebook_size, cfg.dim), generator=generator,
                       device=device, dtype=torch.float32) * (2 * bound) - bound
    if cfg.use_cosine_sim:
        embed = l2norm(embed)
    return VQState(embed=embed,
                   cluster_size=torch.zeros(cfg.codebook_size, device=device),
                   initted=torch.ones(1, device=device))


def vq_lookup(cfg: VQConfig, state: VQState,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest code of each latent.  x: (..., D) -> (the raw codebook rows
    (..., D) fp32, indices (...) int64); ties go to the lowest index."""
    flat = x.reshape(-1, cfg.dim).float()
    embed = state.embed.float()
    if cfg.use_cosine_sim:
        dist = l2norm(flat) @ l2norm(embed).t()
    else:
        dist = -(flat.square().sum(dim=1, keepdim=True) - 2 * flat @ embed.t()
                 + embed.square().sum(dim=1)[None])
    ind = torch.argmax(dist, dim=-1)
    quant = embed[ind]
    return quant.reshape(x.shape), ind.reshape(x.shape[:-1])


def indices_to_embedding(state: VQState, indices: torch.Tensor) -> torch.Tensor:
    """Codebook rows of `indices` (reference: quantize_lucid.py:499-506)."""
    return state.embed[torch.as_tensor(indices, device=state.embed.device).long()]
