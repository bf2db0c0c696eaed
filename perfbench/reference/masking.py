"""The pretraining masking's token budgets, written out plainly from the
reference (egom2p/data/masking.py:181-234 and 519-564), for judging how
many tokens the program's masker makes live.

Per sample: a mixture component drawn by `sampling_weights`; the input
budget, `num_input_tokens` split over the modalities by a Dirichlet draw of
that component's input alphas (floored; the tokens the floor leaves go one
by one to the argmax of fresh draws), each modality capped at its token
count; the target budget, `num_target_tokens` split alike by the target
alphas, each modality capped at the tokens its inputs left.  Every
modality here is an image-like grid whose minimum is 0, so no draw is
redrawn, and a row's live inputs and targets are the sums of its budgets.

`live_count_z` compares the mean live inputs and targets a row of the rows
a run fed against these budgets' mean, in standard errors of a mean over
that many rows (the budgets' spread from a large seeded sample).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

SAMPLE_ROWS = 200_000


def _split(rng: np.random.Generator, alphas: np.ndarray, total: int,
           cap: np.ndarray) -> np.ndarray:
    """(rows, mods) budgets: `total` split by Dirichlet(alphas) a row,
    floored, the rest by argmax of fresh draws, capped at `cap`."""
    rows, mods = cap.shape
    budget = np.floor(rng.dirichlet(alphas, size=rows) * total).astype(np.int64)
    rest = total - budget.sum(axis=1)
    extra = rng.dirichlet(alphas, size=(rows, mods)).argmax(axis=-1)
    for k in range(mods):
        take = rest > k
        np.add.at(budget, (np.flatnonzero(take), extra[take, k]), 1)
    return np.minimum(budget, cap)


def budgets(rng: np.random.Generator, alphas_config: Dict, token_counts: Dict[str, int],
            n_in: int, n_tgt: int, rows: int):
    """(live inputs, live targets) of `rows` samples, each (rows,)."""
    mods = sorted(token_counts)
    mix = alphas_config["alphas_mixture"]
    a_in = np.clip(np.array([mix[m]["input_alphas"] for m in mods], float).T, 1e-9, None)
    a_tgt = np.clip(np.array([mix[m]["target_alphas"] for m in mods], float).T, 1e-9, None)
    w = np.asarray(alphas_config["sampling_weights"], float)
    comp = rng.choice(len(w), size=rows, p=w / w.sum())
    size = np.array([token_counts[m] for m in mods], np.int64)
    live_in = np.zeros(rows, np.int64)
    live_tgt = np.zeros(rows, np.int64)
    for c in range(len(w)):
        sel = np.flatnonzero(comp == c)
        if not len(sel):
            continue
        cap = np.broadcast_to(size, (len(sel), len(mods)))
        b_in = _split(rng, a_in[c], n_in, cap)
        b_tgt = _split(rng, a_tgt[c], n_tgt, cap - b_in)
        live_in[sel], live_tgt[sel] = b_in.sum(axis=1), b_tgt.sum(axis=1)
    return live_in, live_tgt


def live_count_z(fed_inputs: Sequence[int], fed_targets: Sequence[int], alphas_config: Dict,
                 token_counts: Dict[str, int], n_in: int, n_tgt: int, seed: int) -> Dict:
    """The readings: each mean a row, the reference's, and the larger
    distance of the two means from the reference's in standard errors."""
    ref_in, ref_tgt = budgets(np.random.default_rng(seed), alphas_config, token_counts, n_in,
                              n_tgt, SAMPLE_ROWS)
    n = len(fed_inputs)
    out = {"live_rows": float(n)}
    z = []
    for name, fed, ref in (("inputs", fed_inputs, ref_in), ("targets", fed_targets, ref_tgt)):
        mean = float(np.mean(fed))
        out[f"live_{name}_mean"] = mean
        out[f"live_{name}_reference"] = float(ref.mean())
        z.append(abs(mean - ref.mean()) / (ref.std() / np.sqrt(n)))
    out["live_count_z"] = float(max(z))
    return out
