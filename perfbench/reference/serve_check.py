"""The comparison that decides a serving run's `correct`, stage by stage on
one batch that the window produced:

1. tokens: the reference tokenizer on the batch's clips (the benchmark's
   own inputs) against the program's conditioning tokens: the number that
   differ;
2. generation: for each ROAR step, the reference's guided logits at the
   step's positions, given the program's conditioning tokens (checked in
   1) and the target tokens the program served in earlier steps: the widest
   gap by which a served token's logit lies below the reference's best;
3. decode: the reference decoder on the program's target tokens against
   the program's uint8 video: the number of values more than one level off.

The positions of each step are worked out again from the step's seed, as
ROAR draws them (a numpy generator per step, a random tie-break over the
positions still open; reference: egom2p/models/generate.py:447-516).
Weights come from perfbench/weights.py, with the seeds the program's
were drawn from.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench import weights
from perfbench.reference import cosmos
from perfbench.reference.egom2p import EgoM2PReference, egom2p_shapes


def linear_schedule(steps: int, total: int) -> List[int]:
    """Tokens a step, largest first (reference: generate schedules, linear)."""
    cuts = np.linspace(0, total, steps + 1, dtype=int)
    tokens = np.sort(np.diff(cuts))[::-1]
    return [int(t) for t in tokens if t > 0]


def step_positions(seed: int, steps: List[int], total: int) -> List[np.ndarray]:
    """The positions each ROAR step fills, the same for every row."""
    done = np.zeros(total, dtype=bool)
    out = []
    for s, k in enumerate(steps):
        tie = np.random.default_rng(seed + s).random(total) * 1e-6
        order = np.argsort(done.astype(np.float64) + tie)
        pos = np.sort(order[:k])
        done[pos] = True
        out.append(pos)
    return out


def tokenizer_reference(tok_cfg: Dict, seed: int, device, tf32: bool = False):
    cfg = cosmos.config_of(tok_cfg)
    with torch.device("meta"):
        net = cosmos.DiscreteVideoTokenizer(cfg)
        shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    net = cosmos.DiscreteVideoTokenizer(cfg).to(device)
    values = weights.draw(shapes, seed, "cosmos", device)
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(values.pop(n))
    return net.eval()


def model_reference(config: Dict, seed: int, device, quant=None) -> EgoM2PReference:
    shapes = egom2p_shapes(config["model"], config["modalities"])
    return EgoM2PReference(weights.draw(shapes, seed, "egom2p", device), config["model"],
                           config["modalities"], quant=quant)


@torch.no_grad()
def check_tokens(clips: torch.Tensor, program_tokens: np.ndarray, tok_cfg: Dict, seed: int,
                 device, tf32: bool = False) -> Dict[str, float]:
    """Stage 1 on uint8 clips (B, T, H, W, 3); `tf32` computes the control."""
    net = tokenizer_reference(tok_cfg, seed, device)
    with cosmos.tf32(tf32):
        ref = net.tokenize(clips.to(device)).reshape(clips.shape[0], -1).cpu().numpy()
    return {"tokens_differ": float((ref != program_tokens).sum()), "tokens": float(ref.size)}


@torch.no_grad()
def check_decode(program_target: np.ndarray, program_video: np.ndarray, tok_cfg: Dict,
                 grid, seed: int, device, gray: bool, tf32: bool = False) -> Dict[str, float]:
    """Stage 3: the program's target tokens (B, n) through the reference
    decoder against its uint8 video (B, T, H, W, 3), decoded a clip at a time."""
    net = tokenizer_reference(tok_cfg, seed, device)
    off, worst = 0, 0
    for b in range(program_target.shape[0]):
        idx = torch.from_numpy(program_target[b:b + 1].reshape(1, *grid)).to(device)
        with cosmos.tf32(tf32):
            ref = net.decode(idx, program_video.shape[1], gray).cpu().numpy()
        diff = np.abs(ref.astype(np.int16) - program_video[b:b + 1].astype(np.int16))
        off += int((diff > 1).sum())
        worst = max(worst, int(diff.max()))
    return {"video_off": float(off), "video_worst": float(worst)}


@torch.no_grad()
def check_generation(ref: EgoM2PReference, cond_tokens: np.ndarray, served: np.ndarray,
                     cond: str, target: str, seed: int, steps: int, cfg_scale: float,
                     control: EgoM2PReference = None) -> Dict[str, float]:
    """Stage 2 over every row of the batch and every step.  With `control`
    (the reference in a lower precision) the gap read is that of the token
    the control puts first, instead of the program's served token."""
    device = ref.p["mask_token"].device
    total = served.shape[1]
    sched = linear_schedule(steps, total)
    positions = step_positions(seed, sched, total)
    worst, gaps = 0.0, []
    for b in range(served.shape[0]):
        cond_ids = torch.from_numpy(cond_tokens[b].astype(np.int64)).to(device)
        cond_in = {cond: (torch.arange(len(cond_ids), device=device), cond_ids)}
        done = np.zeros(total, dtype=bool)
        for pos in positions:
            known_pos = np.flatnonzero(done)
            known = {}
            if len(known_pos):
                known[target] = (torch.from_numpy(known_pos).to(device),
                                 torch.from_numpy(served[b, known_pos].astype(np.int64)).to(device))
            q = torch.from_numpy(pos).to(device)
            lg = ref.guided_logits(cond_in, known, target, q, cfg_scale)
            if control is None:
                pick = torch.from_numpy(served[b, pos].astype(np.int64)).to(device)
            else:
                pick = control.guided_logits(cond_in, known, target, q, cfg_scale).argmax(-1)
            gap = lg.max(dim=-1).values - lg.gather(1, pick[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            gaps.append(gap.cpu())
            done[pos] = True
    g = torch.cat(gaps)
    return {"gap_max": worst, "gap_p99": float(torch.quantile(g, 0.99)),
            "gap_mean": float(g.mean())}
