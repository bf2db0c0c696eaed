"""EgoM2P pretraining entry point of the PyTorch port, on one device.

Port of run_training_egom2p.py: the same argument names for what is
ported (and an optional --config YAML, which needs PyYAML; keys of what is
not ported are ignored), the token-budget derivation of epochs
and warmup, the cosine / inverse-sqrt / constant LR schedules, AdamW, the
training loop (aborting on a non-finite loss), a JSON line per epoch in
<output_dir>/log.txt and a final checkpoint-final.pth holding the model's
and the optimizer's state dicts.  It runs on the first CUDA device
(--device cuda, the default) and raises when there is none; --device cpu
asks for the CPU (tiny smoke runs and tests).

Smoke run without data (the config's settings as arguments):
    python -m egom2p_torch.cli.run_training --synthetic_data \
        --model egom2p_base_12e_12d_swiglu_nobias --batch_size 8 \
        --lr_schedule constant --epochs 1 --epoch_size 48

Not ported yet: training on token shards (--data_config), data-parallel
and sharded training, validation and fixed-eval loops, auto-resume, warm
starts, frozen-trunk phases, S3 sync, wandb and profiling.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

MODS4 = ("tok_rgb", "tok_depth", "tok_cam", "tok_gaze")


def get_args(argv=None):
    from egom2p_torch.core.config import parse_args_with_config

    p = argparse.ArgumentParser("EgoM2P pretraining (PyTorch)", allow_abbrev=False)
    p.add_argument("--num_input_tokens", type=int, default=2048)
    p.add_argument("--num_target_tokens", type=int, default=2048)
    p.add_argument("--loss_type", default="mod",
                   choices=["mod", "modality", "weighted_mod", "token"])
    p.add_argument("--model", default="egom2p_base_12e_12d_swiglu_nobias")
    p.add_argument("--epochs", type=int, default=-1)
    p.add_argument("--total_tokens", type=float, default=500,
                   help="in billions; derives epochs when --epochs < 0")
    p.add_argument("--opt_betas", type=float, nargs=2, default=[0.9, 0.95])
    p.add_argument("--blr", type=float, default=1e-4)
    p.add_argument("--min_blr", type=float, default=0.0)
    p.add_argument("--warmup_epochs", type=int, default=-1)
    p.add_argument("--warmup_tokens", type=float, default=10)
    p.add_argument("--warmup_steps", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--clip_grad", type=float, default=1.0)
    p.add_argument("--lr_schedule", default="cosine",
                   choices=["cosine", "inverse_sqrt", "constant"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epoch_size", type=int, default=1_000_000)
    p.add_argument("--synthetic_data", action="store_true",
                   help="random token streams instead of tar shards")
    p.add_argument("--scaled_modalities", action="store_true",
                   help="tiny vocab/grid modality registry (CPU smoke runs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train; cuda raises when no CUDA device is found")
    p.add_argument("--output_dir", default="output/egom2p")
    p.add_argument("--print_freq", type=int, default=10)
    return parse_args_with_config(p, argv)


def modality_info(args) -> Dict:
    from egom2p_torch.data.modality_info import (MODALITY_INFO,
                                                 make_scaled_modality_info)
    if args.scaled_modalities:
        return make_scaled_modality_info()
    return {m: dict(MODALITY_INFO[m]) for m in MODS4}


def setup_data(args):
    """The synthetic train mixture loader (reference:
    run_training_egom2p.py:200-231): a seeded pool of 256 random token
    streams through UnifiedMasking and MixtureLoader."""
    from egom2p_torch.data.loader import DatasetStream, MixtureLoader
    from egom2p_torch.data.masking import UnifiedMasking

    if not args.synthetic_data:
        raise NotImplementedError("training on token shards is not ported yet: "
                                  "pass --synthetic_data")
    info = modality_info(args)
    for m in info:
        info[m]["input_alphas"] = [0.01, 0.1, 1.0, 10.0]
        info[m]["target_alphas"] = [0.01, 0.1, 1.0, 10.0]
    masking = UnifiedMasking(info, args.num_input_tokens, args.num_target_tokens,
                             sampling_weights=[1.0] * 4, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    # fixed pool so short smoke runs can demonstrably memorize
    pool = [{m: rng.integers(0, info[m]["vocab_size"],
                             size=info[m]["max_tokens"]).astype(np.int32)
             for m in MODS4} for _ in range(256)]
    loader = MixtureLoader([DatasetStream(lambda: iter(pool), masking)], info,
                           args.batch_size * args.accum_steps, seed=args.seed)
    return loader, sorted(MODS4)


def lr_schedule(args) -> np.ndarray:
    """Epochs, warmup and the per-step LR from the token budgets
    (reference: run_training_egom2p.py:446-469); sets args.epochs and
    args.warmup_steps where they are derived."""
    from egom2p_torch.core.schedules import (constant_scheduler, cosine_scheduler,
                                             inverse_sqrt_scheduler)

    global_batch = args.batch_size * args.accum_steps
    tokens_per_sample = args.num_input_tokens + args.num_target_tokens
    if args.epochs < 0:
        if args.total_tokens <= 0:
            raise ValueError("set --epochs or a positive --total_tokens")
        args.epochs = math.ceil(args.total_tokens * 1e9 / (tokens_per_sample * args.epoch_size))
        print(f"total tokens {args.total_tokens}B -> {args.epochs} epochs")
    if args.warmup_epochs < 0 and args.warmup_steps < 0:
        args.warmup_steps = math.ceil(args.warmup_tokens * 1e9
                                      / (tokens_per_sample * global_batch))
    niter_per_ep = max(args.epoch_size // global_batch, 1)
    lr = args.blr * global_batch / 256.0
    min_lr = args.min_blr * global_batch / 256.0
    warmup = dict(warmup_epochs=max(args.warmup_epochs, 0), warmup_steps=args.warmup_steps)
    if args.lr_schedule == "cosine":
        return cosine_scheduler(lr, min_lr, args.epochs, niter_per_ep, **warmup)
    if args.lr_schedule == "inverse_sqrt":
        return inverse_sqrt_scheduler(lr, min_lr, args.epochs, niter_per_ep, **warmup)
    return constant_scheduler(lr, args.epochs, niter_per_ep)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(args, on_step: Optional[Callable[[int, Dict[str, float], float], None]] = None):
    """Train; returns {"model", "optimizer", "step_seconds", "metrics"}.

    `on_step(step, metrics, seconds)` runs after every step; `seconds` is
    the step's wall time between two device synchronizations."""
    from egom2p_torch.core.logging import JsonlLogger, MetricLogger
    from egom2p_torch.core.optim import Optimizer
    from egom2p_torch.data.loader import batch_to_device
    from egom2p_torch.models.egom2p import create_model
    from egom2p_torch.train.egom2p_train import make_train_step

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: the trainer runs on the first CUDA device; "
                           "pass --device cpu to train on the CPU")
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    loader, domains = setup_data(args)
    sched = lr_schedule(args)
    global_batch = args.batch_size * args.accum_steps
    tokens_per_sample = args.num_input_tokens + args.num_target_tokens
    niter_per_ep = max(args.epoch_size // global_batch, 1)
    print(f"device {device}, global batch {global_batch}, {niter_per_ep} steps per epoch, "
          f"{args.epochs} epochs, first LR {sched[0]:.3e}")

    model_info = modality_info(args) if args.scaled_modalities else None
    model = create_model(args.model, domains, domains, modality_info=model_info, device=device)
    model.init_random_(torch.Generator(device=device).manual_seed(args.seed))
    print(f"model {args.model}: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params")
    optimizer = Optimizer(model, sched, weight_decay=args.weight_decay,
                          betas=tuple(args.opt_betas), clip_grad=args.clip_grad)
    step_fn = make_train_step(model, optimizer, args.num_input_tokens,
                              args.num_target_tokens, args.loss_type, args.accum_steps)
    shuffle = torch.Generator().manual_seed(args.seed + 1)
    jsonl = JsonlLogger(args.output_dir)

    step_seconds, history, step = [], [], 0
    loader_it = iter(loader)
    try:
        for epoch in range(args.epochs):
            logger = MetricLogger(print_freq=args.print_freq)
            for _ in logger.log_every(range(niter_per_ep), header=f"Epoch [{epoch}]",
                                      total=niter_per_ep):
                raw = next(loader_it)
                batch = batch_to_device(raw, device)
                _sync(device)
                t0 = time.perf_counter()
                metrics = step_fn(batch, shuffle)
                _sync(device)
                seconds = time.perf_counter() - t0
                values = {k: float(v) for k, v in metrics.items()}
                if not np.isfinite(values["loss"]):
                    # dump the offending batch and abort
                    # (reference: run_training_egom2p.py:731-734)
                    os.makedirs(args.output_dir, exist_ok=True)
                    dump = os.path.join(args.output_dir, "debug_mod_dict.npz")
                    np.savez(dump, **{f"{m}_{k}": v for m, d in raw.items()
                                      for k, v in d.items()})
                    print(f"Loss is {values['loss']}, stopping training. Batch dumped to {dump}")
                    raise SystemExit(1)
                logger.update(**values)
                step_seconds.append(seconds)
                history.append(values)
                if on_step is not None:
                    on_step(step, values, seconds)
                step += 1
            jsonl.write({"epoch": epoch, "tokens_seen_B": step * tokens_per_sample
                         * global_batch / 1e9,
                         **{k: v.global_avg for k, v in logger.meters.items()}})
    finally:
        loader_it.close()
    path = os.path.join(args.output_dir, "checkpoint-final.pth")
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": step, "args": vars(args)}, path)
    print(f"saved {path}")
    return {"model": model, "optimizer": optimizer, "step_seconds": step_seconds,
            "metrics": history}


if __name__ == "__main__":
    main(get_args())
