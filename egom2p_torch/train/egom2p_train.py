"""EgoM2P pretraining step on one device.

Port of egom2p_tpu/train/egom2p_train.py:make_train_step (reference:
run_training_egom2p.py:678-798): the batch is split into `accum_steps`
micro-batches, each micro-batch's loss / accum_steps is back-propagated into
the summed gradients, and the optimizer clips and applies the update.
Parameters are fp32 and activations run in the model's compute dtype (bf16
by default), with no loss scaling.  Data, tensor and FSDP parallelism are
not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from egom2p_torch.core.optim import Optimizer
from egom2p_torch.models.egom2p import EgoM2P


def make_train_step(model: EgoM2P, optimizer: Optimizer, num_input_tokens: int,
                    num_target_tokens: int, loss_type: str = "mod", accum_steps: int = 1):
    """Returns train_step(batch, shuffle=None) -> metrics.

    `batch` is a mod dict of device tensors with a leading (accum_steps *
    micro-batch) dimension; `shuffle` is the CPU generator that draws each
    micro-batch's decoder modality order.  The metrics `loss`, `grad_norm`
    (before clipping) and `loss_<mod>` are fp32 0-d device tensors."""

    def train_step(batch: Dict[str, Dict[str, torch.Tensor]],
                   shuffle: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        rows = next(iter(next(iter(batch.values())).values())).shape[0]
        if rows % accum_steps:
            raise ValueError(f"batch of {rows} rows does not split into {accum_steps} micro-batches")
        micro = rows // accum_steps
        loss_sum, mod_sums = 0.0, {}
        for i in range(accum_steps):
            md = {m: {k: v[i * micro:(i + 1) * micro] for k, v in d.items()}
                  for m, d in batch.items()}
            loss, mod_loss = model(md, num_input_tokens, num_target_tokens, loss_type,
                                   shuffle=shuffle)
            (loss / accum_steps).backward()
            loss_sum = loss_sum + loss.detach()
            for m, v in mod_loss.items():
                mod_sums[m] = mod_sums.get(m, 0.0) + v.detach()
        grad_norm = optimizer.step()
        return {"loss": loss_sum / accum_steps, "grad_norm": grad_norm,
                **{f"loss_{m}": v / accum_steps for m, v in mod_sums.items()}}

    return train_step
