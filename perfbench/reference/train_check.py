"""The comparison that decides a training run's `correct`: the reference
follows the program's first three steps from the same seeded weights, on
the masked batches the program's loader made.

1. The masked batches themselves (they are the program's, so they are
   judged before the reference uses them): every row's four token arrays
   are one sample the benchmark wrote to the shards, no token is both an
   input and a target, the input and target budgets hold, and the decoder
   attention encoding counts the targets; and every row the loader handed
   out in the run keeps the budgets' rule (`judge_budgets`).  Both count
   into `masked_rows_bad` (exact).  Beside it, the mean live inputs and
   targets a row of every row handed out against the reference masking's
   (`reference/masking.py`: `live_count_z`).
2. Each step's loss and per-modality losses (`loss_gap`: the largest
   absolute gap).
3. The first gradient as the optimizer received it (clipped), read from the
   program's Adam state after one step (exp_avg / (1 - beta1)), leaf by
   leaf (`grad1_gap`).
4. The parameters' change after three steps, leaf by leaf (`change_gap`).

3 and 4 take the gap between the program's norm and the reference's for
each leaf over the larger of that leaf's reference norm and the median
leaf's, and report the worst leaf.  Leaves whose reference gradient is
under a thousandth of the median leaf's move under Adam by round-off alone
(a key's bias under softmax would; these models have no biases but
decoder_proj_context's) and are left out of 4 by that rule.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench import weights
from perfbench.reference.cosmos import tf32
from perfbench.reference.egom2p import EgoM2PReference, adamw_reference, egom2p_shapes


MIN_LOSS_TARGETS = 256


def no_decay(name: str, shape) -> bool:
    """The reference optimizer's skip rule (optim_factory.py:113-115)."""
    return len(shape) <= 1 or "norm" in name or name.endswith("bias")


def judge_rows(batch: Dict[str, Dict[str, np.ndarray]], samples: Dict[bytes, Dict],
               n_in: int, n_tgt: int) -> int:
    """The number of rows of a masked batch that break 1. above."""
    rows = next(iter(batch.values()))["tensor"].shape[0]
    bad = 0
    for r in range(rows):
        key = np.ascontiguousarray(batch["tok_rgb"]["tensor"][r]).reshape(-1).tobytes()
        smp = samples.get(key)
        ok = smp is not None
        n_inputs = n_targets = 0
        for mod, d in batch.items():
            tensor = np.asarray(d["tensor"][r]).reshape(-1)
            inp, tgt = ~d["input_mask"][r], ~d["target_mask"][r]
            ok = ok and np.array_equal(tensor, smp[mod].reshape(-1))
            ok = ok and not (inp & tgt).any()
            n_inputs += int(inp.sum())
            n_targets += int(tgt.sum())
            attn = d["decoder_attention_mask"][r]
            first = np.flatnonzero(tgt)
            ok = ok and int(attn.sum()) == len(first)
            ok = ok and (len(first) == 0 or int(attn[first[0]]) == len(first))
        ok = ok and n_inputs <= n_in and n_targets <= n_tgt
        bad += not ok
    return bad


def judge_budgets(inputs: np.ndarray, targets: np.ndarray, token_counts: List[int], n_in: int,
                  n_tgt: int) -> int:
    """The number of rows, of (rows, mods) live input and target counts a
    modality, that break the budgets' rule: a row's budgets split the whole
    of `n_in` and of `n_tgt` over the modalities and only a modality's size
    caps its share, so a row has fewer than `n_in` inputs only where some
    modality is input whole, and fewer than `n_tgt` targets only where some
    modality's inputs and targets take all of its tokens; never more."""
    size = np.asarray(token_counts)[None, :]
    n_i, n_t = inputs.sum(axis=1), targets.sum(axis=1)
    ok_in = (n_i == n_in) | ((n_i < n_in) & (inputs == size).any(axis=1))
    ok_tgt = (n_t == n_tgt) | ((n_t < n_tgt) & (inputs + targets == size).any(axis=1))
    return int((~(ok_in & ok_tgt)).sum())


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    names = [n for n in ref if keep is None or n in keep]
    med = float(np.median([ref[n] for n in names]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def reference_steps(config: Dict, tr: Dict, seed: int, batches: List[Dict], device,
                    global_batch: int, quant=None, grad_rows=None) -> Dict:
    """The reference's steps (fp32, TF32 off, a batch row at a time); `quant`
    rounds the products' operands (a control); `grad_rows` (a fault) lets
    only those rows' losses into the gradient, as one rank's gradient
    without the exchange between ranks."""
    shapes = egom2p_shapes(config["model"], config["modalities"])
    params = weights.draw(shapes, seed, "egom2p", device)
    start = {n: p.clone() for n, p in params.items()}
    names = sorted(params)
    for p in params.values():
        p.requires_grad_(True)
    ref = EgoM2PReference(params, config["model"], config["modalities"], quant=quant, remat=True)
    state = [dict() for _ in names]
    lr = tr["blr"] * global_batch / 256.0
    losses, grad1, target_counts = [], None, []
    with tf32(False):
        for batch in batches:
            rows = next(iter(batch.values()))["tensor"].shape[0]
            counts = {m: int((~d["target_mask"]).sum()) for m, d in batch.items()}
            target_counts.append(counts)
            n_mods = len(batch)
            mod_loss = dict.fromkeys(batch, 0.0)
            for r in range(rows):
                row = {m: {k: v[r] for k, v in d.items()} for m, d in batch.items()}
                with torch.set_grad_enabled(grad_rows is None or r in grad_rows):
                    ce = ref.row_ce_sums(row, tr["num_input_tokens"], tr["num_target_tokens"])
                if not ce:
                    continue
                loss = sum(v / counts[m] for m, v in ce.items()) / n_mods
                if loss.requires_grad:
                    loss.backward()
                for m, v in ce.items():
                    mod_loss[m] += float(v.detach()) / counts[m]
            step = {f"loss_{m}": v for m, v in mod_loss.items()}
            step["loss"] = sum(mod_loss.values()) / n_mods
            losses.append(step)
            with torch.no_grad():
                grads = [params[n].grad if params[n].grad is not None
                         else torch.zeros_like(params[n]) for n in names]
                clipped = adamw_reference([params[n] for n in names], grads, state,
                                          [not no_decay(n, shapes[n]) for n in names], lr,
                                          tr["opt_betas"], tr["weight_decay"], tr["clip_grad"])
                if grad1 is None:
                    grad1 = {n: float(g.norm()) for n, g in zip(names, clipped)}
            for p in params.values():
                p.grad = None
    with torch.no_grad():
        change = {n: float((params[n] - start[n]).norm()) for n in names}
    return {"losses": losses, "grad1": grad1, "change": change, "counts": target_counts}


def compare(program: Dict, reference: Dict, bad_rows: int) -> Dict[str, float]:
    """The numbers compared, from the program's readings (`losses`, `grad1`,
    `change`, as reference_steps returns them) and the reference's.
    `loss_gap` takes each step's loss and the modality losses over at least
    MIN_LOSS_TARGETS targets; a modality's mean over a handful of targets
    (the 30-token cam and gaze, a few rows of them) swings with bf16's
    rounding by its nature, and stays in `loss_gap_all`, a reading."""
    gaps, gaps_all = [], []
    for p, r, n in zip(program["losses"], reference["losses"], reference["counts"]):
        for k in r:
            gap = abs(p[k] - r[k])
            gaps_all.append(gap)
            if k == "loss" or n.get(k[len("loss_"):], 0) >= MIN_LOSS_TARGETS:
                gaps.append(gap)
    loss_gap, loss_gap_all = max(gaps), max(gaps_all)
    g = reference["grad1"]
    med = float(np.median(list(g.values())))
    moving = {n for n, v in g.items() if v >= 1e-3 * med}
    grad1 = _leaf_gaps(program["grad1"], g)
    change = _leaf_gaps(program["change"], reference["change"], moving)
    worst_g, worst_c = max(grad1, key=grad1.get), max(change, key=change.get)
    return {"masked_rows_bad": float(bad_rows), "loss_gap": loss_gap,
            "loss_gap_all": loss_gap_all, "grad1_gap": grad1[worst_g],
            "change_gap": change[worst_c], "leaves_left_out": float(len(g) - len(moving)),
            "grad1_worst_leaf": worst_g, "change_worst_leaf": worst_c,
            "change_worst_leaf_norms": (program["change"][worst_c], reference["change"][worst_c],
                                        g[worst_c])}
