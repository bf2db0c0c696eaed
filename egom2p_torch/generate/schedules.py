"""Generation schedules.

A copy of egom2p_tpu/generate/schedules.py (pure numpy): importing it from
the JAX package would load its sampler, and with it JAX.

Token-count, temperature and CFG schedules plus the chained schedule builder,
numerically matching the reference
(reference: egom2p/utils/generation.py:49-99, egom2p/models/generate.py:197-320).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np


def cosine_schedule(num_steps: int, total_tokens: int) -> np.ndarray:
    iters = np.arange(num_steps)
    sched = np.array([0.5 * (1 + math.cos(math.pi * i / num_steps)) for i in iters])
    tokens = [round(total_tokens * d) for d in (sched[:-1] - sched[1:])]
    tokens.append(total_tokens - sum(tokens))
    return np.array(tokens)


def linear_schedule(num_steps: int, total_tokens: int) -> np.ndarray:
    sched = np.linspace(0, total_tokens, num_steps + 1, dtype=int)
    tokens = np.diff(sched)[::-1]
    tokens = np.sort(tokens)[::-1]
    return np.trim_zeros(tokens, "b")


def continue_schedule(schedule: np.ndarray, num_current_tokens: int) -> np.ndarray:
    cs = np.cumsum(schedule)
    keep = cs > num_current_tokens
    new = schedule[keep].copy()
    new[0] = cs[keep][0] - num_current_tokens
    return new


def linear_temp_schedule(temp: float, token_schedule: np.ndarray) -> np.ndarray:
    return np.concatenate([
        np.array([temp * 1.0]),
        (temp * (token_schedule.sum() - token_schedule.cumsum())
         / token_schedule.sum())[:-1],
    ]).clip(min=1e-9)


def onex_temp_schedule(max_t: float, min_t: float, token_schedule: np.ndarray,
                       power: float = 0.5, min_linspace: float = 1,
                       max_linspace: float = 100) -> np.ndarray:
    x = np.linspace(min_linspace, max_linspace, num=int(np.sum(token_schedule)))
    y = 1 / (x ** power)
    y = y - y.min()
    y = y / y.max()
    cs = np.cumsum(token_schedule) / np.sum(token_schedule)
    unscaled = [(1 - c) * u for u, c in zip(y, cs)]
    return np.array([min_t + (max_t - min_t) * s for s in unscaled]).clip(min=1e-9)


def build_chained_generation_schedules(
        cond_domains: List[str],
        target_domains: List[str],
        tokens_per_target: List[int],
        autoregression_schemes: List[str],
        decoding_steps: List[int],
        token_decoding_schedules: List[str],
        temps: List[float],
        temp_schedules: List[str],
        cfg_scales: List[float],
        cfg_schedules: List[str],
        cfg_grow_conditioning: bool = False,
        modality_info: Optional[dict] = None):
    """Flat list of per-step dicts
    {target_domain, scheme, num_tokens, temperature, cfg_scale, cfg_cond_domains}
    (reference: generate.py:197-320)."""
    chained = []
    cond_domains = list(cond_domains)
    for ti, target_domain in enumerate(target_domains):
        scheme = autoregression_schemes[ti]
        ntoks = tokens_per_target[ti]
        temp = temps[ti]

        if scheme == "autoregressive":
            chained.append({
                "target_domain": target_domain, "scheme": scheme,
                "num_tokens": None, "temperature": temp,
                "cfg_scale": cfg_scales[ti],
                "cfg_cond_domains": cond_domains.copy(),
            })
            continue

        if modality_info is not None:
            assert modality_info[target_domain]["type"] not in ("seq", "seq_token"), \
                f"Illegal scheme {scheme} for {target_domain}"

        num_steps = decoding_steps[ti]
        if scheme == "maskgit":
            tok_name = token_decoding_schedules[ti]
            if tok_name == "cosine":
                token_schedule = cosine_schedule(num_steps, ntoks)
            elif tok_name == "linear":
                token_schedule = linear_schedule(num_steps, ntoks)
            else:
                raise ValueError(tok_name)
        elif scheme == "roar":
            token_schedule = linear_schedule(num_steps, ntoks)
        else:
            raise ValueError(scheme)

        tname = temp_schedules[ti]
        if tname == "linear":
            temp_schedule = linear_temp_schedule(temp, token_schedule)
        elif tname == "constant":
            temp_schedule = temp * np.ones(len(token_schedule))
        elif "onex" in tname:
            min_t, power = [float(f) for f in tname.split(":")[1:]]
            temp_schedule = onex_temp_schedule(temp, min_t, token_schedule, power)
        else:
            raise ValueError(tname)

        cname = cfg_schedules[ti]
        if cname == "constant":
            cfg = cfg_scales[ti]
            if isinstance(cfg, float):
                cfg_schedule = cfg * np.ones(len(token_schedule))
            else:
                cfg_schedule = np.array(cfg) * np.ones(len(token_schedule)).reshape(-1, 1)
        else:
            raise ValueError(cname)

        chained.extend([
            {"target_domain": target_domain, "scheme": scheme,
             "num_tokens": int(tok), "temperature": float(t),
             "cfg_scale": c, "cfg_cond_domains": cond_domains.copy()}
            for tok, t, c in zip(token_schedule, temp_schedule, cfg_schedule)
        ])
        if cfg_grow_conditioning:
            cond_domains.append(target_domain)
    return chained
