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

`freeze_until` holds the shared trunk still for the first steps of a run
(egom2p_tpu/core/optim.py:freeze_until, `--frozen_model_epochs`).

On a model that core/fsdp.py sharded, the optimizer is built on the
pieces: Adam's moments follow the parameters' sharding (state_shardings(
fsdp=True) in the JAX package), AdamW and the freezes run on the pieces,
and the global gradient norm is the square root of the squared norms of
the pieces summed over the ranks plus those of the replicated parameters,
each of these counted once (their gradients are the same on every rank).
`state_dict` / `load_state_dict` exchange the full moments, as a
checkpoint holds them: `state_dict` gathers them (a collective: every rank
calls it).

The VQ-VAE trainer's optimizer is another chain (run_training_vqvae.py:
633-641): clip_by_global_norm then optax.adamw with no mask, so every
parameter decays (`Optimizer(..., decay_all=True)`), and with --freeze_enc
`freeze_masked` after AdamW: the frozen parameters' gradients still count
in the clip norm and their Adam moments still accumulate; only their
updates, weight decay included, are zeroed.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from egom2p_torch.core import distributed, fsdp


def no_decay(name: str, p: torch.Tensor) -> bool:
    """The reference's skip rule (optim_factory.py:113-115)."""
    return p.dim() <= 1 or "norm" in name or name.endswith("bias")


class Optimizer:
    """torch AdamW in two parameter groups plus clipping and the schedule
    (egom2p_tpu.core.optim.create_optimizer).  `lr_schedule` is the per-step
    LR array (core/schedules.py), clamped at its last value.

    `decay_all` decays every parameter, norms and biases too (the VQ-VAE
    trainer's unmasked optax.adamw).

    `step()` clips the gradients, sets this step's LR and applies the
    update, holding the parameters `freeze_until` names still while they
    are frozen and those `freeze_masked` names always; it returns the
    global gradient norm before clipping."""

    def __init__(self, model: nn.Module, lr_schedule: Sequence[float],
                 weight_decay: float = 0.05, betas=(0.9, 0.95), eps: float = 1e-8,
                 clip_grad: Optional[float] = 1.0, decay_all: bool = False):
        decay, skip = [], []
        for name, p in model.named_parameters():
            if p.requires_grad:
                (skip if no_decay(name, p) and not decay_all else decay).append(p)
        self.params = decay + skip
        self.fsdp = fsdp.state_of(model)
        self.frozen, self.frozen_steps = [], 0  # freeze_until
        self.masked = []                        # freeze_masked
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
        frozen = self.frozen if self.step_count < self.frozen_steps else []
        with torch.no_grad():
            for p in frozen:
                p.grad = torch.zeros_like(p)
            frozen = frozen + self.masked  # gradients kept: clipped and in Adam's moments
            held = [p.detach().clone() for p in frozen]
        clip = self.clip_grad if self.clip_grad else float("inf")
        if self.fsdp is not None and self.fsdp.world > 1:
            gnorm = self._clip_sharded_(clip)
        else:
            gnorm = torch.nn.utils.clip_grad_norm_(self.params, clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr
        self.adamw.step()
        self.step_count += 1
        with torch.no_grad():
            for p, h in zip(frozen, held):
                p.copy_(h)
        return gnorm

    def _clip_sharded_(self, clip: float) -> torch.Tensor:
        """clip_grad_norm_ over the ranks' pieces and the replicated
        gradients (the module docstring)."""
        pieces, replicated = [], []
        for p in self.params:
            if p.grad is not None:
                (pieces if self.fsdp.sharded(p) is not None else replicated).append(p.grad)

        def squares(grads):
            if not grads:
                return torch.zeros((), device=self.params[0].device)
            return torch.stack(torch._foreach_norm(grads)).square().sum()

        total = (distributed.all_reduce_sum_(squares(pieces)) + squares(replicated)).sqrt()
        coef = torch.clamp(clip / (total + 1e-6), max=1.0)
        torch._foreach_mul_(pieces + replicated, coef)
        return total

    def _moments(self, state):
        """(AdamW state index, sharded parameter) of every piece that has
        Adam state, in the state dict's order."""
        order = [p for g in self.adamw.param_groups for p in g["params"]]
        return [(i, self.fsdp.sharded(p)) for i, p in enumerate(order)
                if self.fsdp.sharded(p) is not None and i in state]

    def state_dict(self):
        """Adam's state with full moments (gathered on a sharded model: a
        collective), the schedule's position."""
        sd = self.adamw.state_dict()
        if self.fsdp is not None:
            state = dict(sd["state"])
            for i, s in self._moments(state):
                state[i] = {k: self.fsdp.gather(v, s) if k in ("exp_avg", "exp_avg_sq") else v
                            for k, v in state[i].items()}
            sd = {**sd, "state": state}
        return {"adamw": sd, "step_count": self.step_count}

    def load_state_dict(self, state) -> None:
        """Adam's full moments and step (a sharded model keeps its pieces),
        and the schedule's position."""
        sd = state["adamw"]
        if self.fsdp is not None:
            moments = dict(sd["state"])
            for i, s in self._moments(moments):
                moments[i] = {k: self.fsdp.piece(v, s).clone()
                              if k in ("exp_avg", "exp_avg_sq") else v
                              for k, v in moments[i].items()}
            sd = {**sd, "state": moments}
        self.adamw.load_state_dict(sd)
        self.step_count = int(state["step_count"])


_TRUNK = re.compile(r"(encoder|decoder)\.\d+\..+|(encoder|decoder)_norm\..+")


def shared_params_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True for the shared transformer trunk: the encoder
    and decoder blocks and their final norms, the set the reference freezes
    in its warm-start phases (egom2p_tpu/core/optim.py:shared_params_mask;
    reference: egom2p_model.py:805-807).  decoder_proj_context, the
    embeddings and the tokens stay trainable."""
    return {name: bool(_TRUNK.fullmatch(name)) for name, _ in model.named_parameters()}


def freeze_until(frozen_steps: int, frozen_mask: Dict[str, bool], optimizer: Optimizer,
                 model: nn.Module) -> Optimizer:
    """Hold `model`'s parameters that `frozen_mask` marks still while fewer
    than `frozen_steps` steps have run (reference frozen-model phases:
    run_training_egom2p.py:686-693), as egom2p_tpu/core/optim.py:freeze_until
    does: their gradients are zeroed before clipping and Adam (the global
    norm sees only the trainable ones, and their Adam moments stay at their
    initial zeros while Adam's step count runs on), and their updates,
    weight decay included, are undone after it.  Returns `optimizer`."""
    optimizer.frozen_steps = frozen_steps
    optimizer.frozen = [p for name, p in model.named_parameters() if frozen_mask.get(name)]
    return optimizer


def freeze_modules_mask(model: nn.Module,
                        module_names: Sequence[str] = ("encoder", "quant_proj")) -> Dict[str, bool]:
    """Parameter name -> True for the parameters under any module named in
    `module_names` (egom2p_tpu/core/optim.py:freeze_modules_mask): the
    reference's FREEZE_MODULES encoder freeze for VQ-VAE finetuning
    (reference: egom2p/vq/vqvae.py:32, 200-223)."""
    names = set(module_names)
    return {name: bool(names & set(name.split(".")[:-1]))
            for name, _ in model.named_parameters()}


def freeze_masked(frozen_mask: Dict[str, bool], optimizer: Optimizer,
                  model: nn.Module) -> Optimizer:
    """Hold `model`'s parameters that `frozen_mask` marks still for good,
    as egom2p_tpu/core/optim.py:freeze_masked chained after clipping and
    AdamW does (--freeze_enc): their gradients stay, count in the clip
    norm and fill their Adam moments; their updates, weight decay included,
    are undone after each step.  Returns `optimizer`."""
    optimizer.masked = [p for name, p in model.named_parameters() if frozen_mask.get(name)]
    return optimizer
