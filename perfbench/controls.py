#!/usr/bin/env python3
"""The controls and faults that set each cell's upper readings, run on the
card at the cell's own sizes (the benchmark's own runs never run them):

    python3 perfbench/controls.py --workload <cell> --seeds 101 102 103

Each prints one JSON line a seed with the numbers a run compares:
- serving: the reference put in the program's place in the nearest lower
  precision (the Cosmos encode and decode on TF32 for exact fp32; EgoM2P's
  products with fp8 e4m3 operands for bf16, reading the gap of the token the
  control puts first), and one served token altered where it is produced;
- training: the reference's three steps with fp8 e4m3 forward products
  (gradients pass straight through) for bf16, half of each batch left out
  (the mean over the rest), and across chips the exchange of gradients left
  out (rank 0's update from its own rows); a step that returns its state
  unchanged reads 1 by the change's measure and needs no run;
- the masking (`--masking_rows N`, host code, no card needed): the
  program's masker over N rows, as a run's loader hands them out, sound and
  with two faults planted in it: cam and gaze weighed tenfold in every
  Dirichlet draw (fewer live tokens, the budgets' rule kept) and every
  budget cut by a quarter.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import weights  # noqa: E402
from perfbench.reference import egom2p as ref_model  # noqa: E402
from perfbench.reference import serve_check, train_check  # noqa: E402


def straight_through_fp8(x):
    return x + (ref_model.fp8_round(x) - x).detach()


@torch.no_grad()
def serve_controls(ctx) -> dict:
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    B = tr["batch"]
    tok_seed, model_seed = weights.sub_seed(seed, 2), weights.sub_seed(seed, 1)
    clips = weights.clip_pool(weights.sub_seed(seed, 3), tr["pool"], tuple(tr["clip"]), dev)[:B]
    grid = tuple(cfg["modalities"][tr["target"]]["grid"])
    out = {}
    net = serve_check.tokenizer_reference(cfg["tokenizer"], tok_seed, dev)
    tokens = net.tokenize(clips.to(dev)).reshape(B, -1).cpu().numpy()
    del net
    out["tokens_differ"] = serve_check.check_tokens(clips, tokens, cfg["tokenizer"], tok_seed,
                                                    dev, tf32=True)["tokens_differ"]
    # the decode: the fp32 reference's video of the reference tokens against TF32's
    net = serve_check.tokenizer_reference(cfg["tokenizer"], tok_seed, dev)
    video = np.concatenate([net.decode(torch.from_numpy(tokens[b:b + 1].reshape(1, *grid))
                                       .to(dev), tr["clip"][0], True).cpu().numpy()
                            for b in range(B)])
    del net
    out["video_off"] = serve_check.check_decode(tokens, video, cfg["tokenizer"], grid, tok_seed,
                                                dev, gray=True, tf32=True)["video_off"]
    # generation: the fp8 control's greedy tokens, each step on its own earlier picks
    ref = serve_check.model_reference(cfg, model_seed, dev)
    ctl = serve_check.model_reference(cfg, model_seed, dev, quant=ref_model.fp8_round)
    step_seed = weights.sub_seed(seed, 100)
    served = _greedy(ctl, tokens, tr, step_seed)
    gen = serve_check.check_generation(ref, tokens, served, tr["cond"], tr["target"], step_seed,
                                       tr["decoding_steps"], tr["cfg_scale"])
    out.update({f"control_{k}": v for k, v in gen.items()})
    out["gap_max"] = gen["gap_max"]
    # a fault: one served token altered where it is produced (the reference's
    # own greedy tokens, the first row's first position changed)
    greedy = _greedy(ref, tokens[:1], tr, step_seed)
    altered = greedy.copy()
    V = cfg["modalities"][tr["target"]]["vocab_size"]
    altered[0, 0] = (altered[0, 0] + 1 + np.random.default_rng(seed).integers(V - 1)) % V
    out["fault_altered_token_gap_max"] = serve_check.check_generation(
        ref, tokens[:1], altered, tr["cond"], tr["target"], step_seed, tr["decoding_steps"],
        tr["cfg_scale"])["gap_max"]
    out["fault_sound_greedy_gap_max"] = serve_check.check_generation(
        ref, tokens[:1], greedy, tr["cond"], tr["target"], step_seed, tr["decoding_steps"],
        tr["cfg_scale"])["gap_max"]
    return out


def _greedy(model, cond_tokens, tr, step_seed):
    """`model`'s greedy tokens through the ROAR steps, each step conditioned
    on its own earlier picks."""
    dev = model.p["mask_token"].device
    total = cond_tokens.shape[1]
    sched = serve_check.linear_schedule(tr["decoding_steps"], total)
    positions = serve_check.step_positions(step_seed, sched, total)
    served = np.zeros_like(cond_tokens)
    for b in range(cond_tokens.shape[0]):
        cond_ids = torch.from_numpy(cond_tokens[b].astype(np.int64)).to(dev)
        cond_in = {tr["cond"]: (torch.arange(total, device=dev), cond_ids)}
        done = np.zeros(total, dtype=bool)
        for pos in positions:
            kp = np.flatnonzero(done)
            known = ({tr["target"]: (torch.from_numpy(kp).to(dev),
                                     torch.from_numpy(served[b, kp].astype(np.int64)).to(dev))}
                     if len(kp) else {})
            lg = model.guided_logits(cond_in, known, tr["target"],
                                     torch.from_numpy(pos).to(dev), tr["cfg_scale"])
            served[b, pos] = lg.argmax(-1).cpu().numpy()
            done[pos] = True
    return served


def masked_batches(ctx, steps: int):
    """`steps` batches from the program's masking over the shards' samples
    (the program's loader does the same to the same samples)."""
    from egom2p_torch.data.masking import UnifiedMasking
    from egom2p_torch.data.modality_info import MODALITY_INFO
    from perfbench.drivers import train
    tr = ctx.traffic
    mods = sorted(tr["shard_dirs"])
    info = {m: {**MODALITY_INFO[m], **tr["alphas"]["alphas_mixture"][m]} for m in mods}
    masking = UnifiedMasking(info, tr["num_input_tokens"], tr["num_target_tokens"],
                             sampling_weights=tr["alphas"]["sampling_weights"], seed=ctx.seed)
    pool = [s for shard in train.shard_samples(ctx.config, tr, weights.sub_seed(ctx.seed, 5))
            for s in shard]
    rng = np.random.default_rng(ctx.seed)
    rows = tr["batch"] * tr["world"]
    out = []
    for _ in range(steps):
        picks = [masking(pool[i]) for i in rng.integers(len(pool), size=rows)]
        out.append({m: {k: np.stack([p[m][k] for p in picks]) for k in picks[0][m]}
                    for m in mods})
    return out


def masking_controls(ctx, rows: int) -> dict:
    """`masked_rows_bad`'s budget rule and `live_count_z` over `rows` rows
    of the program's masking, sound and with each planted fault."""
    from egom2p_torch.data.masking import UnifiedMasking
    from perfbench.reference import masking
    tr = ctx.traffic
    mods = sorted(tr["shard_dirs"])
    counts = {m: int(np.prod(ctx.config["modalities"][m]["grid"])) for m in mods}
    real_init, real_budget = UnifiedMasking.__init__, UnifiedMasking._budget

    def tenfold(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        for i, m in enumerate(self.modality_info):
            if m in ("tok_cam", "tok_gaze"):
                self.input_alphas[:, i] *= 10
                self.target_alphas[:, i] *= 10

    def quarter(self, *args, **kwargs):
        return [b * 3 // 4 for b in real_budget(self, *args, **kwargs)]

    out = {}
    for name, init, budget in (("", real_init, real_budget),
                               ("fault_cam_gaze_tenfold_", tenfold, real_budget),
                               ("fault_quarter_budget_", real_init, quarter)):
        UnifiedMasking.__init__, UnifiedMasking._budget = init, budget
        try:
            one = dict(ctx.traffic, batch=rows, world=1)
            batch = masked_batches(SimpleNamespace(**{**vars(ctx), "traffic": one}), 1)[0]
        finally:
            UnifiedMasking.__init__, UnifiedMasking._budget = real_init, real_budget
        fed_in = np.stack([(~batch[m]["input_mask"]).sum(axis=1) for m in mods], axis=1)
        fed_tgt = np.stack([(~batch[m]["target_mask"]).sum(axis=1) for m in mods], axis=1)
        live = masking.live_count_z(fed_in.sum(axis=1), fed_tgt.sum(axis=1), tr["alphas"],
                                    counts, tr["num_input_tokens"], tr["num_target_tokens"],
                                    weights.sub_seed(ctx.seed, 6))
        live["masked_rows_bad"] = float(train_check.judge_budgets(
            fed_in, fed_tgt, list(counts.values()), tr["num_input_tokens"],
            tr["num_target_tokens"]))
        out.update({name + k: v for k, v in live.items()})
    return out


def train_controls(ctx) -> dict:
    tr, dev = ctx.traffic, ctx.device
    batches = masked_batches(ctx, tr["warmup_steps"])
    seed = weights.sub_seed(ctx.seed, 1)
    rows = tr["batch"] * tr["world"]
    ref = train_check.reference_steps(ctx.config, tr, seed, batches, dev, rows)
    ctl = train_check.reference_steps(ctx.config, tr, seed, batches, dev, rows,
                                      quant=straight_through_fp8)
    out = {f"control_{k}": v for k, v in train_check.compare(ctl, ref, 0).items()}
    half = [{m: {k: v[: rows // 2] for k, v in d.items()} for m, d in b.items()}
            for b in batches]
    fault = train_check.reference_steps(ctx.config, tr, seed, half, dev, rows)
    out.update({f"fault_half_batch_{k}": v for k, v in train_check.compare(fault, ref, 0).items()})
    if tr["world"] > 1:  # rank 0's update on its own rows' gradient alone
        fault = train_check.reference_steps(ctx.config, tr, seed, batches, dev, rows,
                                            grad_rows=set(range(tr["batch"])))
        out.update({f"fault_no_exchange_{k}": v
                    for k, v in train_check.compare(fault, ref, 0).items()})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--masking_rows", type=int, default=0,
                   help="read the masking's numbers over this many rows instead")
    args = p.parse_args(argv)
    from perfbench import run as runner
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in args.seeds:
        ctx = runner.context(args.workload, seed, 0.0, False, dev)
        t0 = time.time()
        if args.masking_rows:
            out = masking_controls(ctx, args.masking_rows)
        else:
            out = (serve_controls if ctx.cell["driver"] == "serve" else train_controls)(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.time() - t0, **out}), flush=True)
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    return 0


if __name__ == "__main__":
    sys.exit(main())
