"""EgoM2P pretraining and evaluation steps, on one process or data-parallel
over a process group.

Port of egom2p_tpu/train/egom2p_train.py:make_train_step and
make_eval_step (reference: run_training_egom2p.py:678-834): the batch is split into `accum_steps`
micro-batches, each micro-batch's loss / accum_steps is back-propagated into
the summed gradients, and the optimizer clips and applies the update.
Parameters are fp32 and activations run in the model's compute dtype (bf16
by default), with no loss scaling.  The eval step is the deterministic
forward: eval mode (no stochastic depth), the decoder's modalities in
sorted order, no gradient.

With a process group (core/distributed.py) the steps compute what the JAX
step computes in one jit over the global batch, the ranks' batches stacked
in rank order:
- each modality's loss is the CE total over its target count in the whole
  global micro-batch: every forward sums its counts over the ranks
  (EgoM2P.forward's `count_reduce`, one small all-reduce), so each rank's
  loss is its share of the global loss and the shares sum to it;
- micro-batch i is global rows [i G/A, (i+1) G/A) of the G-row global
  batch, as JAX's reshape of the process-ordered array: with A > 1 the
  ranks' batches are gathered (a few MB of tokens and masks) and rank r
  takes its b rows of each micro-batch, so every rank runs every
  micro-batch on b rows, enters each collective once and draws the same
  decoder order and stochastic-depth masks (for all G/A rows, taking its
  own) from its generator;
- the gradients are summed over the ranks in flat buckets of all_reduce
  (a gradient that is None, a head no row of this rank reached, enters as
  zeros) before the norm and the clipping, so every rank applies the same
  update and the parameters stay bitwise equal;
- the metrics are the global batch's, the same on every rank.
DistributedDataParallel would mean the per-rank losses instead, which is
another loss wherever the ranks hold different numbers of a modality's
targets.

On a model that core/fsdp.py sharded (--fsdp) the step is the same
computation: the root unit is gathered for the step's micro-batches (each
block gathers its own weights around its forward and its backward), and
after the last backward the sharded parameters' gradients are
reduce-scattered with SUM into each rank's pieces and the replicated
ones all-reduced, before the optimizer's clipping and AdamW on the pieces.
The eval step gathers the root unit around its forward.  Tensor
parallelism is not ported (TPU-only machinery).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from egom2p_torch.core import distributed, fsdp
from egom2p_torch.core.optim import Optimizer
from egom2p_torch.models.egom2p import EgoM2P

def _rows(batch) -> int:
    return next(iter(next(iter(batch.values())).values())).shape[0]


def _take(batch, lo: int, hi: int):
    return {m: {k: v[lo:hi] for k, v in d.items()} for m, d in batch.items()}


def gather_batch(batch):
    """The ranks' batches stacked in rank order: the global batch."""
    out = {}
    for m, d in batch.items():
        out[m] = {}
        for k, v in d.items():
            # bool travels as uint8: not every backend gathers bool tensors
            g = distributed.all_gather_rows(v.to(torch.uint8) if v.dtype == torch.bool else v)
            out[m][k] = g.bool() if v.dtype == torch.bool else g
    return out


def make_train_step(model: EgoM2P, optimizer: Optimizer, num_input_tokens: int,
                    num_target_tokens: int, loss_type: str = "mod", accum_steps: int = 1):
    """Returns train_step(batch, shuffle=None) -> metrics.

    `batch` is a mod dict of device tensors with a leading (accum_steps *
    micro-batch) dimension, this rank's rows of the global batch;
    `shuffle` is the CPU generator that draws each micro-batch's decoder
    modality order.  The metrics `loss`, `grad_norm` (before clipping) and
    `loss_<mod>` are fp32 0-d device tensors, of the global batch where a
    process group is formed (the module's docstring)."""
    parallel = distributed.initialized()
    world, rank = distributed.world_size(), distributed.rank()
    count_reduce = distributed.all_reduce_sum_ if parallel else None
    sharded = fsdp.state_of(model)

    def train_step(batch: Dict[str, Dict[str, torch.Tensor]],
                   shuffle: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        rows = _rows(batch)
        if rows % accum_steps:
            raise ValueError(f"batch of {rows} rows does not split into {accum_steps} micro-batches")
        micro = rows // accum_steps
        gathered = world > 1 and accum_steps > 1
        if gathered:
            batch = gather_batch(batch)
        draws = (rank * micro, world * micro) if parallel else None
        loss_sum, mod_sums = 0.0, {}
        if sharded is not None:
            sharded.unshard_root()
        for i in range(accum_steps):
            lo = (i * world + rank) * micro if gathered else i * micro
            md = _take(batch, lo, lo + micro)
            loss, mod_loss = model(md, num_input_tokens, num_target_tokens, loss_type,
                                   shuffle=shuffle, count_reduce=count_reduce, rows=draws)
            (loss / accum_steps).backward()
            if sharded is not None:
                sharded.after_backward()
            loss_sum = loss_sum + loss.detach()
            for m, v in mod_loss.items():
                mod_sums[m] = mod_sums.get(m, 0.0) + v.detach()
        metrics = {"loss": loss_sum / accum_steps,
                   **{f"loss_{m}": v / accum_steps for m, v in mod_sums.items()}}
        if sharded is not None:
            sharded.reshard_root()
            sharded.reduce_grads_([p for p in optimizer.params if sharded.sharded(p) is None])
        elif parallel:
            distributed.all_reduce_grads_(optimizer.params)
        if parallel:
            metrics = distributed.global_metrics(metrics)
        grad_norm = optimizer.step()
        return {"loss": metrics.pop("loss"), "grad_norm": grad_norm, **metrics}

    return train_step


def make_eval_step(model: EgoM2P, num_input_tokens: int, num_target_tokens: int,
                   loss_type: str = "mod"):
    """Returns eval_step(batch) -> {"loss", "loss_<mod>"}: fp32 0-d device
    tensors of the deterministic loss, of the global batch where a process
    group is formed (`batch` is then this rank's rows of it); the model is
    left in eval mode (train_step sets training mode again)."""
    parallel = distributed.initialized()
    sharded = fsdp.state_of(model)

    @torch.no_grad()
    def eval_step(batch: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        model.eval()
        if sharded is not None:
            sharded.unshard_root()
        try:
            loss, mod_loss = model(batch, num_input_tokens, num_target_tokens, loss_type,
                                   count_reduce=distributed.all_reduce_sum_ if parallel else None)
        finally:
            if sharded is not None:
                sharded.reshard_root()
        metrics = {"loss": loss, **{f"loss_{m}": v for m, v in mod_loss.items()}}
        return distributed.global_metrics(metrics) if parallel else metrics

    return eval_step
