"""LR / weight-decay schedules, as precomputed numpy arrays indexed by step.

Copy of egom2p_tpu/core/schedules.py (reference:
egom2p/utils/scheduler.py:21-100), numpy only: importing the JAX package's
module would load jax through egom2p_tpu/core/__init__.py.
"""
from __future__ import annotations

import math

import numpy as np


def cosine_scheduler(base_value, final_value, epochs, niter_per_ep,
                     warmup_epochs=0, start_warmup_value=0, warmup_steps=-1):
    """(reference: scheduler.py:21-38)"""
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    # short smoke runs can ask for more warmup than total steps (e.g. the
    # token-derived default warmup with --epochs 1): clamp instead of crash
    warmup_iters = min(warmup_iters, epochs * niter_per_ep)
    warmup = (np.linspace(start_warmup_value, base_value, warmup_iters)
              if warmup_iters > 0 else np.array([]))
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    n = max(len(iters), 1)
    sched = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(math.pi * iters / n))
    out = np.concatenate([warmup, sched])
    assert len(out) == epochs * niter_per_ep
    return out


def constant_scheduler(base_value, epochs, niter_per_ep):
    return base_value * np.ones(epochs * niter_per_ep)


def inverse_sqrt_scheduler(base_value, final_value, epochs, niter_per_ep,
                           warmup_epochs=0, start_warmup_value=0,
                           warmup_steps=-1, cooldown_epochs=0,
                           cooldown_steps=-1, timescale=10_000):
    """(reference: scheduler.py:46-100)"""
    warmup_iters = warmup_epochs * niter_per_ep
    if warmup_steps > 0:
        warmup_iters = warmup_steps
    warmup_iters = min(warmup_iters, epochs * niter_per_ep)
    cooldown_iters = cooldown_epochs * niter_per_ep
    if cooldown_steps > 0:
        cooldown_iters = cooldown_steps
    cooldown_iters = min(cooldown_iters, epochs * niter_per_ep - warmup_iters)

    warmup = (np.linspace(start_warmup_value, base_value, warmup_iters)
              if warmup_iters > 0 else np.array([]))
    iters = np.arange(epochs * niter_per_ep - warmup_iters - cooldown_iters)
    if base_value == final_value:
        sched = base_value * np.ones(len(iters))
    else:
        sched = base_value / np.sqrt((iters + timescale) / timescale)
    if cooldown_iters > 0:
        cooldown = np.linspace(sched[-1] if len(sched) else base_value,
                               final_value, cooldown_iters)
    else:
        cooldown = np.array([])
    out = np.concatenate([warmup, sched, cooldown])
    assert len(out) == epochs * niter_per_ep
    return out
