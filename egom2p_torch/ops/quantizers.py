"""Gradient-trained quantizers: the taming-style VectorQuantizer and Memcodes.

Port of egom2p_tpu/ops/quantizers.py:

  * `TamingVectorQuantizer` (reference: cosmos_tokenizer/modules/
    quantizers.py:230-389): the nearest code by euclidean distance, the
    codebook trained by gradient through `emb + beta * commit` (the legacy
    weighting) or `beta * emb + commit`, the straight-through estimator, the
    perplexity diagnostic, optional index remapping and the
    `get_codebook_entry` decode;
  * `Memcodes` (reference: egom2p/vq/quantizers/quantize_memcodes.py:25-124):
    each head's queries attend over learned codes, with a hard gumbel
    softmax at train time (straight-through) and an argmax at eval.

Both take channel-last (B, N, D) sequences (fold any grid first) and compute
in fp32.  Their codebooks are parameters the optimizer updates, unlike the
EMA codebook of ops/vq.py.  Parameter names follow the JAX package's
(`embedding`, as an nn.Embedding: `embedding.weight`, the reference torch
key the JAX converter reads; `codes`, `to_k`, `to_v` in the JAX layout).

Randomness is the caller's: the gumbel noise of Memcodes' training forward
and the draws of the 'random' remap come in as tensors or from a
torch.Generator.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated normal: the standard deviation of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None):
    """flax.linen.initializers.lecun_normal(): a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class TamingVectorQuantizer(nn.Module):
    """(reference: cosmos_tokenizer/modules/quantizers.py:230-389)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, beta: float = 0.25,
                 legacy: bool = True, use_norm: bool = False,
                 remap: Optional[Sequence[int]] = None,
                 unknown_index: Union[str, int] = "random"):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.beta, self.legacy, self.use_norm = beta, legacy, use_norm
        self.remap = None if remap is None else tuple(int(i) for i in remap)
        self.unknown_index = unknown_index
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)

    @torch.no_grad()
    def init_random_(self, generator: Optional[torch.Generator] = None):
        """The JAX package's init: uniform in [-1/n, 1/n)."""
        bound = 1.0 / self.num_embeddings
        self.embedding.weight.uniform_(-bound, bound, generator=generator)
        return self

    def _norm(self, t):
        if not self.use_norm:
            return t
        return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)

    def forward(self, z: torch.Tensor, remap_draws: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """z: (B, N, D) -> (z_q straight-through, loss, (indices, commit,
        emb_loss, perplexity)); indices (B, N).  `remap_draws` (or
        `generator`) give the 'random' remap's draws for unknown codes."""
        codes = self.embedding.weight
        flat = z.reshape(-1, self.embedding_dim).float()
        d = (flat.square().sum(dim=1, keepdim=True) + codes.square().sum(dim=1)[None]
             - 2 * flat @ codes.t())
        ind = torch.argmin(d, dim=1)
        z_q = codes[ind].reshape(z.shape)

        zf = z.float()
        z_qn, zn = self._norm(z_q), self._norm(zf)
        # the reference's names: `commit` trains the codebook, `emb_loss` the encoder
        commit = (z_qn - zn.detach()).square().mean()
        emb_loss = (z_qn.detach() - zn).square().mean()
        loss = emb_loss + self.beta * commit if self.legacy else self.beta * emb_loss + commit

        z_q = zf + (z_q - zf).detach()  # straight-through

        avg = torch.bincount(ind, minlength=self.num_embeddings).float() / ind.numel()
        perplexity = torch.exp(-(avg * torch.log(avg + 1e-10)).sum())

        indices = ind.reshape(z.shape[:-1])
        if self.remap is not None:
            indices = self.remap_to_used(indices, remap_draws, generator)
        return z_q.to(z.dtype), loss, (indices, commit, emb_loss, perplexity)

    # -- index remapping (reference: quantizers.py:282-306) -----------------
    def remap_to_used(self, inds: torch.Tensor, draws: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        used = torch.as_tensor(self.remap, device=inds.device)
        match = inds[..., None] == used
        new = torch.argmax(match.to(torch.int32), dim=-1)
        unknown = ~match.any(-1)
        if self.unknown_index == "random":
            if draws is None:
                draws = torch.randint(0, len(self.remap), new.shape, generator=generator,
                                      device=inds.device)
            new = torch.where(unknown, draws.to(new), new)
        elif self.unknown_index == "extra":
            new = torch.where(unknown, torch.full_like(new, len(self.remap)), new)
        else:
            new = torch.where(unknown, torch.full_like(new, int(self.unknown_index)), new)
        return new

    def unmap_to_all(self, inds: torch.Tensor) -> torch.Tensor:
        used = torch.as_tensor(self.remap, device=inds.device)
        inds = torch.where(inds >= len(self.remap), torch.zeros_like(inds), inds)
        return used[inds.long()]

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """indices (...) -> codes (..., D) (reference: quantizers.py:374-389)."""
        indices = torch.as_tensor(indices, device=self.embedding.weight.device)
        if self.remap is not None:
            indices = self.unmap_to_all(indices)
        return self.embedding.weight[indices.long()]


class Memcodes(nn.Module):
    """NWT-style multi-head attention quantizer
    (reference: egom2p/vq/quantizers/quantize_memcodes.py:25-124)."""

    def __init__(self, dim: int, codebook_size: int, heads: int = 1, temperature: float = 1.0):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        self.dim, self.codebook_size, self.heads = dim, codebook_size, heads
        self.temperature = temperature
        hd = dim // heads
        self.codes = nn.Parameter(torch.zeros(heads, codebook_size, hd))
        self.to_k = nn.Parameter(torch.zeros(heads, hd, hd))
        self.to_v = nn.Parameter(torch.zeros(heads, hd, hd))

    @torch.no_grad()
    def init_random_(self, generator: Optional[torch.Generator] = None):
        """The JAX package's init: normal(1) codes, lecun-normal to_k / to_v
        (flax's fan_in of a (heads, hd, hd) kernel: hd x heads)."""
        self.codes.normal_(0.0, 1.0, generator=generator)
        for p in (self.to_k, self.to_v):
            lecun_normal_(p, p.shape[0] * p.shape[1], generator)
        return self

    def _kv(self):
        k = torch.einsum("hnd,hdc->hnc", self.codes, self.to_k)
        v = torch.einsum("hnd,hdc->hnc", self.codes, self.to_v)
        return k, v

    def forward(self, x: torch.Tensor, training: bool = False,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x: (B, N, D) -> (out (B, N, D), a zero codebook loss, indices
        (B, heads, N), or (B, N) for one head).  At train time `noise` holds
        the uniform draws in [1e-9, 1 - 1e-9) of the gumbel noise, shaped
        (B, heads, N, codebook_size); without it they come from
        `generator`."""
        B, N, _ = x.shape
        hd = self.dim // self.heads
        q = x.reshape(B, N, self.heads, hd).transpose(1, 2) * (hd ** -0.5)
        k, v = self._kv()
        logits = torch.einsum("bhid,hjd->bhij", q.float(), k.float())
        if training:
            if noise is None:
                noise = torch.rand(logits.shape, generator=generator, device=logits.device)
                noise = noise * (1.0 - 2e-9) + 1e-9
            g = -torch.log(-torch.log(noise.to(logits)))
            noisy = (logits + g) / self.temperature
            soft = torch.softmax(noisy, dim=-1)
            ind = torch.argmax(noisy, dim=-1)
            hard = F.one_hot(ind, self.codebook_size).to(soft)
            attn = soft + (hard - soft).detach()  # hard=True straight-through
        else:
            ind = torch.argmax(logits, dim=-1)
            attn = F.one_hot(ind, self.codebook_size).float()
        out = torch.einsum("bhij,hjd->bhid", attn, v.to(attn.dtype))
        out = out.transpose(1, 2).reshape(B, N, self.dim)
        if self.heads == 1:
            ind = ind[:, 0]
        return out.to(x.dtype), torch.zeros((), device=x.device), ind

    def indices_to_embedding(self, indices: torch.Tensor) -> torch.Tensor:
        """(B, N) for one head, or (B, heads, N) -> (B, N, dim)
        (reference: quantize_memcodes.py:54-68)."""
        _, v = self._kv()
        indices = torch.as_tensor(indices, device=v.device).long()
        if indices.dim() == 2 and self.heads == 1:
            return v[0][indices]
        out = torch.stack([v[h][indices[:, h]] for h in range(self.heads)], dim=1)
        return out.transpose(1, 2).reshape(indices.shape[0], indices.shape[-1], self.dim)
