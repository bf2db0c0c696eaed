"""The VQ-VAE tokenizers' training step (cam / gaze, rgb / depth video,
teacher features).

Port of egom2p_tpu/train/vqvae_train.py (reference:
run_training_vqvae.py:1011-1074, 1076-1419) for the lucid quantizer, on one
device or data-parallel over a process group:

  * fp32 throughout (the released tokenizer configs train in fp32,
    cfgs/vqvae/{cam,gaze}.yaml `dtype: fp32`);
  * reconstruction losses `mse` and `mse_mask` (the gaze target's last
    channel weights each frame);
  * the codebook's commitment loss and EMA update from ops/vq.py through
    VQAutoencoder.autoencode_train (tokenizers/seq_vqvae.py): the decoder
    sees the codes of the codebook as it was before the batch;
  * the video domains' optional perceptual term, percept_weight x
    percept_loss(pred, target) (core/image_metrics.py:make_perceptual_loss);
  * the optimizer is core/optim.py's Optimizer (the caller builds the
    VQ-VAE chain: clipping, unmasked AdamW, freeze_masked for
    --freeze_enc), and the EMA of the weights (reference ModelEma) follows
    every `ema_update_freq` optimizer steps.

Across processes (core/distributed.py) the step is the JAX trainer's one
jit over the global batch, the ranks' equal batches stacked in rank order
(run_training_vqvae.py:595-627): the reconstruction and commitment losses
are each rank's share of the means over the global batch (gaze's masked
mean divides by the mask count summed over the ranks), the gradients are
summed over the ranks before the clipping, the codebook's statistics are
summed and its expiry draws from the gathered global batch (ops/vq.py),
and the metrics are the global batch's.  Every rank applies the same
update, and the weights, the codebook and the weights' EMA stay equal on
every rank.

The gradient quantizers (taming, memcodes) train through
`make_grad_vqvae_train_step` (egom2p_tpu/train/vqvae_train.py:
make_grad_vqvae_train_step): loss = reconst + codebook_weight x the
quantizer's loss, the codebook a parameter like any other, no EMA codebook
and no perceptual term, the codebook usage counted over `codebook_size`,
and the weights' EMA as above.  Under a process group the losses are each
rank's share of the global batch's and the gradients are summed, as above;
Memcodes' gumbel noise is each rank's own draws.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from egom2p_torch.core import distributed
from egom2p_torch.core.optim import Optimizer


def reconst_loss(pred: torch.Tensor, target: torch.Tensor, loss_fn: str,
                 n_channels: int, world: int = 1,
                 count_reduce: Optional[Callable] = None) -> torch.Tensor:
    """(reference: run_training_vqvae.py:1011-1074).  With `world` ranks
    of equal batches: this rank's share of the global batch's loss
    (`count_reduce` sums mse_mask's mask count over them)."""
    if loss_fn == "mse":
        loss = (pred - target).square().mean()
        return loss / world if world > 1 else loss
    if loss_fn == "mse_mask":
        # gaze: the target's last channel is the validity mask
        data, mask = target[..., :n_channels], target[..., n_channels:]
        se = (pred - data).square() * mask
        count = mask.sum() * n_channels
        if count_reduce is not None:
            count = count_reduce(count.detach().clone())
        return se.sum() / torch.clamp(count, min=1.0)
    raise ValueError(f"unknown loss_fn {loss_fn}")


def init_ema(net: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of `net`'s parameters, the EMA's start (reference ModelEma,
    run_training_vqvae.py:715-724)."""
    return {name: p.detach().clone() for name, p in net.named_parameters()}


@torch.no_grad()
def ema_update(ema: Optional[Dict[str, torch.Tensor]], net: nn.Module, step: int,
               ema_decay: Optional[float], ema_update_freq: int) -> None:
    """e <- e * decay + p * (1 - decay) for every parameter, in place, when
    `step` (the optimizer's step count before this update) is a multiple of
    `ema_update_freq` (egom2p_tpu/train/vqvae_train.py:_ema_update)."""
    if ema_decay is None or ema is None or step % ema_update_freq != 0:
        return
    for name, p in net.named_parameters():
        ema[name].mul_(ema_decay).add_(p.detach() * (1 - ema_decay))


def make_vqvae_train_step(net: nn.Module, optimizer: Optimizer, loss_fn: str = "mse",
                          codebook_weight: float = 1.0,
                          ema: Optional[Dict[str, torch.Tensor]] = None,
                          ema_decay: Optional[float] = None,
                          ema_update_freq: int = 1, percept_loss: Optional[Callable] = None,
                          percept_weight: float = 0.0) -> Callable[..., Dict[str, torch.Tensor]]:
    """The train step of a VQAutoencoder `net`
    (egom2p_tpu/train/vqvae_train.py:make_vqvae_train_step).

    `step(batch, **draws)` runs one step on an fp32 batch on the net's
    device ((B, T, C) sequences, (B, T, H, W, C) clips, (B, h, w, d)
    feature maps): loss = reconst + codebook_weight * commit (+
    percept_weight * percept_loss(pred, batch) when both are set), its gradients,
    the optimizer's step, the codebook's update and, with `ema` and
    `ema_decay`, the weights' EMA.  `draws` pick the replacements of
    expired codes (vq_forward's `generator`, or `replace_idx` /
    `lbg_noise`).  Returns the JAX step's metrics (loss, reconst_loss,
    code_loss, codebook_usage: the share of codes this batch used) and the
    global gradient norm before clipping (grad_norm), as 0-d tensors; under
    a process group `batch` is this rank's rows and the metrics are the
    global batch's (the module docstring)."""

    n_channels = net.n_channels
    codebook_size = net.quantize.cfg.codebook_size
    parallel = distributed.initialized()
    world = distributed.world_size()
    group = (dict(stats_reduce=distributed.all_reduce_sum_,
                  pool_gather=distributed.all_gather_rows, world=world) if parallel else {})

    def step(batch: torch.Tensor, **draws) -> Dict[str, torch.Tensor]:
        net.train()
        pred, commit, tokens = net.autoencode_train(batch, **draws, **group)
        rec = reconst_loss(pred, batch, loss_fn, n_channels, world,
                           distributed.all_reduce_sum_ if parallel else None)
        loss = rec + codebook_weight * commit
        if percept_loss is not None and percept_weight > 0.0:
            # this rank's share of the global batch's mean
            loss = loss + percept_weight * percept_loss(pred, batch) / world
        optimizer.zero_grad()
        loss.backward()
        if parallel:
            distributed.all_reduce_grads_(optimizer.params)
        count = optimizer.step_count
        grad_norm = optimizer.step()
        ema_update(ema, net, count, ema_decay, ema_update_freq)
        metrics = {"loss": loss.detach(), "reconst_loss": rec.detach(),
                   "code_loss": commit.detach()}
        counts = torch.bincount(tokens.reshape(-1), minlength=codebook_size)
        if parallel:
            metrics = distributed.global_metrics(metrics)
            counts = distributed.all_reduce_sum_(counts.float())
        return {**metrics, "codebook_usage": (counts > 0).float().mean(),
                "grad_norm": grad_norm.detach()}

    return step


def make_grad_vqvae_train_step(net: nn.Module, optimizer: Optimizer, loss_fn: str = "mse",
                               codebook_weight: float = 1.0,
                               ema: Optional[Dict[str, torch.Tensor]] = None,
                               ema_decay: Optional[float] = None,
                               ema_update_freq: int = 1) -> Callable[..., Dict[str, torch.Tensor]]:
    """The train step of a GradVQAutoencoder `net` (taming / memcodes;
    egom2p_tpu/train/vqvae_train.py:make_grad_vqvae_train_step).

    `step(batch, noise=None, generator=None)` runs one step on an fp32
    batch on the net's device: the forward in training mode (Memcodes'
    hard gumbel softmax on `noise`, uniform draws in [1e-9, 1 - 1e-9) of
    shape (B, heads, N, codebook_size), or draws from `generator`), loss =
    reconst + codebook_weight * the quantizer's loss, its gradients, the
    optimizer's step and, with `ema` and `ema_decay`, the weights' EMA.
    Returns the JAX step's metrics (loss, reconst_loss, code_loss,
    codebook_usage over `codebook_size`) and the gradient norm before
    clipping (grad_norm), as 0-d tensors."""
    n_channels, codebook_size = net.n_channels, net.codebook_size
    parallel = distributed.initialized()
    world = distributed.world_size()

    def step(batch: torch.Tensor, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        net.train()
        pred, qloss, tokens = net.autoencode_train(batch, True, noise, generator)
        rec = reconst_loss(pred, batch, loss_fn, n_channels, world,
                           distributed.all_reduce_sum_ if parallel else None)
        if world > 1:  # this rank's share of the global batch's mean
            qloss = qloss / world
        loss = rec + codebook_weight * qloss
        optimizer.zero_grad()
        loss.backward()
        if parallel:
            distributed.all_reduce_grads_(optimizer.params)
        count = optimizer.step_count
        grad_norm = optimizer.step()
        ema_update(ema, net, count, ema_decay, ema_update_freq)
        metrics = {"loss": loss.detach(), "reconst_loss": rec.detach(),
                   "code_loss": qloss.detach()}
        counts = torch.bincount(tokens.reshape(-1), minlength=codebook_size)
        if parallel:
            metrics = distributed.global_metrics(metrics)
            counts = distributed.all_reduce_sum_(counts.float())
        return {**metrics, "codebook_usage": (counts > 0).float().mean(),
                "grad_norm": grad_norm.detach()}

    return step
