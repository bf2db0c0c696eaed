"""Vector-quantization codebooks: the lookup and the EMA training update.

Port of egom2p_tpu/ops/vq.py (reference:
egom2p/vq/quantizers/quantize_lucid.py:137-428, 499-506): the codebook state,
its kaiming-uniform init (l2-normalised for the cosine-sim codebook), the
nearest-code lookup, the index -> code-row lookup of decode_tokens, and the
training half:

  * `vq_forward`: the lookup under the current codebook, the commitment
    loss, the straight-through output and the new codebook state: the bincount / segment-sum statistics of the batch, the EMA
    cosine update or the euclidean `embed_avg` update, and dead-code expiry
    under the `batch_random` or `linde_buzo_gray` replacement policy;
  * `kmeans_init_state`: the data-dependent codebook init, run once before
    training.

As in the JAX package the update is functional: `vq_forward` returns a new
`VQState` and leaves the one it was given as it was (the caller writes it
into its buffers after the lookup; tokenizers/seq_vqvae.py does).  The
randomness of expiry and kmeans comes from a `torch.Generator`, or the
caller passes the draws themselves (`replace_idx`, `lbg_noise`, `perm`), so
that a test can feed in the numbers JAX drew from its key.  The main
model's cam and gaze tokenizers use the cosine-sim form (the reference's
norm_codes=True, egom2p/vq/vqvae.py:171-185); the euclidean form is here
too.  Everything computes in fp32.

Across processes (the JAX package's psum over the data axis, reference
sync_codebook=True, quantize_lucid.py:91-135) `vq_forward` takes the
process group's reductions: `stats_reduce` sums the batch's code counts
and embedding sums over the ranks before the EMA update, and
`pool_gather` gathers the ranks' latents in rank order, so that
batch_random expiry draws its replacements from the global batch (with a
generator seeded alike on every rank); linde_buzo_gray needs only the
summed counts.  Every rank then computes the same new codebook, and the
commitment loss is this rank's share of the global batch's mean (the ranks
hold equal batches).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class VQState:
    embed: torch.Tensor          # (K, D) codebook
    cluster_size: torch.Tensor   # (K,) EMA usage counts
    initted: torch.Tensor        # one element: False until a kmeans init ran
    # (K, D) EMA of the assigned latents' sums, kept by the euclidean
    # codebook (quantize_lucid.py:294-297); None for the cosine-sim one
    embed_avg: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class VQConfig:
    """egom2p_tpu.ops.vq.VQConfig's fields but norm_latents, which no
    caller sets."""
    codebook_size: int = 256
    dim: int = 32
    decay: float = 0.99
    eps: float = 1e-5
    threshold_ema_dead_code: float = 0.25
    commitment_weight: float = 1.0
    use_cosine_sim: bool = True
    kmeans_init: bool = False
    # 'batch_random' | 'linde_buzo_gray' (quantize_lucid.py:245-261)
    code_replacement_policy: str = "batch_random"


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=eps)


def init_vq_state(cfg: VQConfig, generator: torch.Generator, device=None) -> VQState:
    """A fresh codebook drawn from `generator`: kaiming-uniform like the
    reference's uniform_init (quantize_lucid.py:41-44), l2-normalised for
    the cosine-sim codebook; all zeros and not initted under kmeans_init
    (kmeans_init_state fills it from data)."""
    device = generator.device if device is None else torch.device(device)
    zeros = torch.zeros(cfg.codebook_size, device=device)
    if cfg.kmeans_init:
        embed = torch.zeros((cfg.codebook_size, cfg.dim), device=device)
        initted = torch.zeros(1, device=device)
    else:
        bound = math.sqrt(3.0) * math.sqrt(2.0 / cfg.dim)
        embed = torch.rand((cfg.codebook_size, cfg.dim), generator=generator,
                           device=device, dtype=torch.float32) * (2 * bound) - bound
        if cfg.use_cosine_sim:
            embed = l2norm(embed)
        initted = torch.ones(1, device=device)
    return VQState(embed=embed, cluster_size=zeros, initted=initted,
                   embed_avg=None if cfg.use_cosine_sim else embed.clone())


def _segment_stats(flat: torch.Tensor, ind: torch.Tensor, k: int):
    """(per-code counts (K,) fp32, per-code sums of `flat` (K, D))."""
    counts = torch.bincount(ind, minlength=k).float()
    sums = torch.zeros((k, flat.shape[-1]), device=flat.device, dtype=flat.dtype)
    return counts, sums.index_add_(0, ind, flat)


def kmeans_init_state(cfg: VQConfig, samples: torch.Tensor, *,
                      perm: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      num_iters: int = 10) -> VQState:
    """kmeans codebook init from (N, D) latents (quantize_lucid.py:137-167):
    the first K rows of `perm` (a permutation of range(N); drawn from
    `generator` when not given) seed the means, then `num_iters` rounds of
    assignment and update; an empty cluster keeps its mean."""
    samples = samples.detach().float().reshape(-1, cfg.dim)
    if cfg.use_cosine_sim:
        samples = l2norm(samples)
    n, k = samples.shape[0], cfg.codebook_size
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=generator.device)
    means = samples[torch.as_tensor(perm, device=samples.device).long()[:k]]
    bins = torch.zeros(k, device=samples.device)
    for _ in range(num_iters):
        if cfg.use_cosine_sim:
            dists = samples @ means.t()
        else:
            dists = -(samples[:, None] - means[None]).square().sum(dim=-1)
        buckets = torch.argmax(dists, dim=-1)
        bins, sums = _segment_stats(samples, buckets, k)
        new_means = sums / torch.clamp(bins, min=1.0)[:, None]
        if cfg.use_cosine_sim:
            new_means = l2norm(new_means)
        means = torch.where((bins == 0)[:, None], means, new_means)
    return VQState(embed=means, cluster_size=bins, initted=torch.ones(1, device=means.device),
                   embed_avg=(None if cfg.use_cosine_sim
                              else means * torch.clamp(bins, min=1.0)[:, None]))


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


@torch.no_grad()
def _updated_state(cfg: VQConfig, state: VQState, flat: torch.Tensor, ind: torch.Tensor,
                   generator: Optional[torch.Generator], replace_idx: Optional[torch.Tensor],
                   lbg_noise: Optional[torch.Tensor], stats_reduce: Optional[Callable] = None,
                   pool_gather: Optional[Callable] = None) -> VQState:
    """The codebook after one batch: `flat` (N, D) the batch's latents (l2-
    normalised for the cosine codebook), `ind` (N,) their codes; the
    statistics summed and the replacement pool gathered over the ranks
    where the reductions are given."""
    k, decay = cfg.codebook_size, cfg.decay
    onehot_sum, embed_sum = _segment_stats(flat, ind, k)
    if stats_reduce is not None:
        stats = stats_reduce(torch.cat([onehot_sum[:, None], embed_sum], dim=1))
        onehot_sum, embed_sum = stats[:, 0], stats[:, 1:]
    cluster_size = state.cluster_size * decay + onehot_sum * (1 - decay)
    embed_avg = None
    if cfg.use_cosine_sim:
        # (quantize_lucid.py:409-426)
        zero = onehot_sum == 0
        denom = torch.where(zero, torch.ones_like(onehot_sum), onehot_sum)
        normalized = l2norm(embed_sum / denom[:, None])
        normalized = torch.where(zero[:, None], state.embed, normalized)
        embed = state.embed * decay + normalized * (1 - decay)
    else:
        # (quantize_lucid.py:286-298): embed_avg is an EMA of the assigned
        # latents' sums, the codebook that over the laplace-smoothed EMA
        # counts; an unused code holds its position
        avg_prev = (state.embed_avg if state.embed_avg is not None
                    else state.embed * torch.clamp(state.cluster_size, min=1.0)[:, None])
        embed_avg = avg_prev * decay + embed_sum * (1 - decay)
        n = cluster_size.sum()
        smoothed = (cluster_size + cfg.eps) / (n + k * cfg.eps) * n
        embed = embed_avg / torch.clamp(smoothed, min=1e-9)[:, None]

    # dead-code expiry (quantize_lucid.py:245-261, 370-386)
    draws = generator is not None or replace_idx is not None or lbg_noise is not None
    if cfg.threshold_ema_dead_code > 0 and draws:
        expired = cluster_size < cfg.threshold_ema_dead_code
        if cfg.code_replacement_policy == "batch_random":
            # each code's replacement: a random latent of the global batch
            pool = flat if pool_gather is None else pool_gather(flat)
            if replace_idx is None:
                replace_idx = torch.randint(0, pool.shape[0], (k,), generator=generator,
                                            device=generator.device)
            repl = pool[torch.as_tensor(replace_idx, device=flat.device).long()]
        elif cfg.code_replacement_policy == "linde_buzo_gray":
            # Linde-Buzo-Gray splitting: dead code i takes the i-th most used
            # code plus tiny noise (quantize_lucid.py:239-243)
            order = torch.argsort(-cluster_size, stable=True)
            rank = torch.clamp(torch.cumsum(expired.long(), dim=0) - 1, 0, k - 1)
            if lbg_noise is None:
                lbg_noise = torch.randn((k, cfg.dim), generator=generator,
                                        device=generator.device)
            repl = embed[order[rank]] + torch.as_tensor(lbg_noise).to(embed) * 1e-10
        else:
            raise ValueError(cfg.code_replacement_policy)
        if cfg.use_cosine_sim:
            repl = l2norm(repl)
        embed = torch.where(expired[:, None], repl, embed)
    return VQState(embed=embed, cluster_size=cluster_size,
                   initted=torch.ones_like(state.initted), embed_avg=embed_avg)


def vq_forward(cfg: VQConfig, state: VQState, x: torch.Tensor, *,
               generator: Optional[torch.Generator] = None,
               replace_idx: Optional[torch.Tensor] = None,
               lbg_noise: Optional[torch.Tensor] = None,
               stats_reduce: Optional[Callable] = None,
               pool_gather: Optional[Callable] = None, world: int = 1):
    """Quantize latents x (..., D) in training
    (egom2p_tpu/ops/vq.py:vq_forward with training=True; inference is
    vq_lookup).

    Returns (quantized, commit_loss, indices, new_state).  The output is
    straight-through (x + (quant - x) with the difference
    detached: the gradient reaches x unchanged), commit_loss is
    commitment_weight * mean((quant - x)^2) with quant detached
    (quantize_lucid.py:533-543), and new_state is the codebook after this
    batch.  The lookup uses `state`'s codebook, which this function never
    writes.  Dead codes expire when threshold_ema_dead_code > 0 and one of
    `generator`, `replace_idx` ((K,) indices into the batch's flattened
    latents, batch_random) or `lbg_noise` ((K, D) standard normal,
    linde_buzo_gray) is given.

    Across `world` processes holding equal batches: `stats_reduce` sums a
    tensor over them (in place, as core/distributed.py:all_reduce_sum_)
    and `pool_gather` stacks their (N, D) rows in rank order
    (all_gather_rows); commit_loss is then this rank's share, the mean
    over the global batch divided among the ranks, and `replace_idx`
    indexes the gathered rows (the module docstring)."""
    with torch.no_grad():
        quant, ind = vq_lookup(cfg, state, x)
    commit_loss = (quant - x.float()).square().mean() * cfg.commitment_weight
    if world > 1:
        commit_loss = commit_loss / world
    flat = x.detach().reshape(-1, cfg.dim).float()
    if cfg.use_cosine_sim:
        flat = l2norm(flat)
    new_state = _updated_state(cfg, state, flat, ind.reshape(-1), generator, replace_idx,
                               lbg_noise, stats_reduce, pool_gather)
    quant = quant.to(x.dtype)
    return x + (quant - x).detach(), commit_loss, ind, new_state


def indices_to_embedding(state: VQState, indices: torch.Tensor) -> torch.Tensor:
    """Codebook rows of `indices` (reference: quantize_lucid.py:499-506)."""
    return state.embed[torch.as_tensor(indices, device=state.embed.device).long()]
