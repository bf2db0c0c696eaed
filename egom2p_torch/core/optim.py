"""AdamW with decoupled weight decay on matrices, global-norm clipping and a
per-step LR schedule.

Port of egom2p_tpu/core/optim.py:create_optimizer (reference:
egom2p/utils/optim_factory.py:98-200).  optax's chain clip -> scale_by_adam
-> add_decayed_weights(mask) -> scale_by_learning_rate gives
p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p) on decayed parameters;
torch.optim.AdamW gives p <- p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps),
the same update.  Clipping scales g by clip / |g| when |g| > clip (torch
adds 1e-6 to |g|, optax does not: a 1e-6 relative difference).  Only
norm parameters, biases and other 1-D parameters go undecayed (mod_emb,
mask_token and the token embeddings are decayed, as in the reference).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn


def no_decay(name: str, p: torch.Tensor) -> bool:
    """The reference's skip rule (optim_factory.py:113-115)."""
    return p.dim() <= 1 or "norm" in name or name.endswith("bias")


class Optimizer:
    """torch AdamW in two parameter groups plus clipping and the schedule
    (egom2p_tpu.core.optim.create_optimizer).  `lr_schedule` is the per-step
    LR array (core/schedules.py), clamped at its last value.

    `step()` clips the gradients, sets this step's LR and applies the
    update; it returns the global gradient norm before clipping."""

    def __init__(self, model: nn.Module, lr_schedule: Sequence[float],
                 weight_decay: float = 0.05, betas=(0.9, 0.95), eps: float = 1e-8,
                 clip_grad: Optional[float] = 1.0):
        decay, skip = [], []
        for name, p in model.named_parameters():
            if p.requires_grad:
                (skip if no_decay(name, p) else decay).append(p)
        self.params = decay + skip
        self.lr_schedule = np.asarray(lr_schedule, dtype=np.float64)
        self.clip_grad = clip_grad
        self.step_count = 0
        self.adamw = torch.optim.AdamW(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": skip, "weight_decay": 0.0}],
            lr=float(self.lr_schedule[0]), betas=tuple(betas), eps=eps)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @property
    def lr(self) -> float:
        return float(self.lr_schedule[min(self.step_count, len(self.lr_schedule) - 1)])

    def step(self) -> torch.Tensor:
        clip = self.clip_grad if self.clip_grad else float("inf")
        gnorm = torch.nn.utils.clip_grad_norm_(self.params, clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr
        self.adamw.step()
        self.step_count += 1
        return gnorm

    def state_dict(self):
        return {"adamw": self.adamw.state_dict(), "step_count": self.step_count}

    def load_state_dict(self, state) -> None:
        """Adam's moments and step, and the schedule's position."""
        self.adamw.load_state_dict(state["adamw"])
        self.step_count = int(state["step_count"])
