"""EgoM2P pretraining entry point of the PyTorch port, on one device or
data-parallel across processes.

Port of run_training_egom2p.py: the same argument names and defaults for
what is ported, a --config file whose keys become defaults (JSON, or YAML
where PyYAML is installed; keys of what is not ported are printed and
ignored), the token-budget derivation of epochs and warmup, the cosine /
inverse-sqrt / constant LR schedules, AdamW, the training loop (aborting on
a non-finite loss), a JSON line per epoch in <output_dir>/log.txt, and
checkpoints in the reference's .pth format (core/checkpoint.py):
checkpoint-{epoch}.pth every --save_ckpt_freq epochs (written on a
background thread with --async_save, the default) and checkpoint-final.pth
after the last (always blocking).

Data: aligned token shards through --data_config (a data config's `train`
datasets, each with its own masking, weighted by `train.weights`;
data/tar_reader.py, data/loader.py with --num_workers forked workers), or
--synthetic_data (with --input_domains and --target_domains, TransferMasking:
fixed input and target modalities; the shard path keeps the Dirichlet
masking, as the JAX trainer does).  After every --eval_freq epochs the held-out `val`
datasets (their config merged over the train dataset's of the same name)
are evaluated over --eval_iters batches, with random token budgets
(val_<name>_*) and with budgets pinned to --fixed_eval_input_tokens /
--fixed_eval_target_tokens and a pinned masking seed (fixed_eval_<name>_*:
the same batches every epoch); --synthetic_data evaluates a held-out
synthetic pool.  --frozen_model_epochs N holds the shared trunk still for
the first N epochs; --use_act_checkpoint recomputes every block in the
backward (--remat_policy full or dots); --num_register_tokens adds learned
encoder tokens.  --profile writes a torch.profiler trace of the first
epoch's steps to <output_dir>/profile and prints the program's spans and
counters over them (core/tracing.py: the data fetch and copy, each step's
forward, backward, all-reduce and optimizer, live tokens against the slots
computed, device allocations); --log_wandb logs to wandb where it is
installed (else nothing).

Across processes (torchrun; core/distributed.py, train/egom2p_train.py):
each process trains on its device (cuda:LOCAL_RANK) with a loader batch of
--batch_size x --accum_steps rows, seeded seed + 7919 x rank, on its share
of the shards; the global batch, batch_size x processes x accum_steps,
sets the steps per epoch, the LR (blr x global / 256) and the warmup, and
each step computes the JAX step's loss and gradients on it.  Validation
reads every shard at batch_size x processes rows a batch, each process
evaluating its rows.  Rank 0 alone prints, writes log.txt and writes the
checkpoints, whose keys are the model's own (no `module.` prefix).
--fsdp true shards the parameters and Adam's moments over the processes
(core/fsdp.py: each block's weights gathered around its forward and its
backward, gradients reduce-scattered); the step, the validation, the
profile and the checkpoint files are those of data parallelism (every
rank takes part in a save's gathers, rank 0 writes), and one process is a
shard of one.

S3: data paths may be s3:// shards (streamed through boto3's client for
--s3_data_endpoint, data/s3_utils.py); --s3_save_dir s3://bucket/prefix
uploads every checkpoint after it lands (--s3_endpoint) and, on a resume
with no local checkpoint, rank 0 first downloads the newest one there
while the other ranks wait (core/s3_sync.py); the run waits for its
uploads before it exits.  Both need boto3 and raise, naming it, without
it.  A data config's dataset of `type: huggingface` reads a local
directory written by `datasets`' save_to_disk (data/hf_datasets.py; each
rank its share, the loader's masking and mixture as for shards).

By default a run resumes from the latest checkpoint in its --output_dir
(model, optimizer, step and the LR schedule's position; --no_auto_resume
starts afresh), preferring the largest checkpoint-{N}.pth over
checkpoint-final.pth, as the JAX package's trainer does.  On shards a
resumed run opens a fresh stream, as the JAX trainer does; on
--synthetic_data each process replays its seeded stream's batches already
trained on.  --finetune PATH warm-starts from the tensors of a checkpoint
whose shapes match.  It runs on CUDA (--device cuda, the default) and
raises when there is none; --device cpu asks for the CPU (tiny runs and
tests; gloo across processes).

    python -m egom2p_torch.cli.run_training --config cfgs/egom2p/main_mod4.yaml
    torchrun --standalone --nproc_per_node 8 -m egom2p_torch.cli.run_training \
        --config cfgs/egom2p/main_mod4.yaml

Smoke run without data (the config's settings as arguments):
    python -m egom2p_torch.cli.run_training --synthetic_data \
        --model egom2p_base_12e_12d_swiglu_nobias --batch_size 8 \
        --lr_schedule constant --epochs 1 --epoch_size 48

Text modalities (a caption in a data config's in_domains / out_domains,
read from the shards' `.txt` members): --text_tokenizer_path names a
WordPiece tokenizer.json (utils/text_tokenizer.py), which the train, val
and fixed-eval maskings span-mask the captions with.

Not ported (it raises where it is asked for): tensor parallelism
(--tensor_parallel > 1, TPU-only machinery).
"""
from __future__ import annotations

import argparse
import math
import os
import random
import re
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from egom2p_torch.core import tracing

MODS4 = ("tok_rgb", "tok_depth", "tok_cam", "tok_gaze")
SYNTHETIC_ALPHAS = [0.01, 0.1, 1.0, 10.0]


def get_args(argv=None):
    from egom2p_torch.core.config import parse_args_with_config, str2bool

    p = argparse.ArgumentParser("EgoM2P pretraining (PyTorch)", allow_abbrev=False)
    p.add_argument("--run_name", default="auto")
    p.add_argument("--num_input_tokens", type=int, default=2048)
    p.add_argument("--num_target_tokens", type=int, default=2048)
    p.add_argument("--loss_type", default="mod",
                   choices=["mod", "modality", "weighted_mod", "token"])
    p.add_argument("--model", default="egom2p_base_12e_12d_swiglu_nobias")
    p.add_argument("--num_register_tokens", type=int, default=0)
    p.add_argument("--use_act_checkpoint", type=str2bool, default=False,
                   help="recompute every encoder and decoder block in the backward")
    p.add_argument("--remat_policy", default="full", choices=["full", "dots"],
                   help="full recomputes whole blocks; dots keeps the unbatched "
                        "products' outputs and recomputes the rest")
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
    p.add_argument("--data_config", default=None)
    p.add_argument("--epoch_size", type=int, default=1_000_000)
    p.add_argument("--num_workers", type=int, default=0,
                   help="forked data-loader worker processes; 0 = one background thread")
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--fixed_eval", action="store_true", default=True)
    p.add_argument("--no_fixed_eval", dest="fixed_eval", action="store_false")
    p.add_argument("--fixed_eval_input_tokens", type=int, default=128)
    p.add_argument("--fixed_eval_target_tokens", type=int, default=128)
    p.add_argument("--eval_iters", type=int, default=10)
    p.add_argument("--frozen_model_epochs", type=int, default=0,
                   help="hold the shared trunk still for the first N epochs")
    p.add_argument("--text_tokenizer_path", default=None,
                   help="a WordPiece tokenizer.json, for caption modalities")
    p.add_argument("--synthetic_data", action="store_true",
                   help="random token streams instead of tar shards")
    p.add_argument("--scaled_modalities", action="store_true",
                   help="tiny vocab/grid modality registry (CPU smoke runs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train; cuda raises when no CUDA device is found")
    p.add_argument("--output_dir", default="output/egom2p")
    p.add_argument("--save_ckpt_freq", type=int, default=1)
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--no_auto_resume", dest="auto_resume", action="store_false")
    p.add_argument("--finetune", default=None,
                   help="warm-start checkpoint (.pth); tensors of another shape keep their init")
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--input_domains", default=None,
                   help="hyphen-separated; with --target_domains, TransferMasking on "
                        "--synthetic_data (fixed input and target modalities)")
    p.add_argument("--target_domains", default=None)
    p.add_argument("--async_save", type=str2bool, default=True,
                   help="periodic checkpoints written on a background thread "
                        "(the final save always blocks)")
    p.add_argument("--profile", action="store_true",
                   help="a torch.profiler trace of the first epoch's steps in "
                        "<output_dir>/profile")
    p.add_argument("--log_wandb", action="store_true", default=False)
    p.add_argument("--no_log_wandb", dest="log_wandb", action="store_false")
    p.add_argument("--wandb_project", default="egom2p-train")
    p.add_argument("--wandb_entity", default=None)
    p.add_argument("--wandb_run_name", default="auto")
    p.add_argument("--fsdp", type=str2bool, default=False,
                   help="shard the parameters and Adam's moments over the processes "
                        "(core/fsdp.py)")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="not ported: raises above 1")
    p.add_argument("--s3_save_dir", default=None,
                   help="s3://bucket/prefix to mirror checkpoints into (needs boto3)")
    p.add_argument("--s3_endpoint", default=None)
    p.add_argument("--s3_data_endpoint", default=None,
                   help="the endpoint of s3:// data shards")
    return parse_args_with_config(p, argv)


def modality_info(args) -> Dict:
    """The four modalities' registry entries (the scaled ones with
    --scaled_modalities)."""
    from egom2p_torch.data.modality_info import (MODALITY_INFO,
                                                 make_scaled_modality_info)
    if args.scaled_modalities:
        return make_scaled_modality_info()
    return {m: dict(MODALITY_INFO[m]) for m in MODS4}


def _synthetic_pool(args, seed: int, n: int):
    """`n` seeded random samples of the four modalities, and their info with
    the synthetic alphas (reference: run_training_egom2p.py:200-231)."""
    info = modality_info(args)
    for m in info:
        info[m]["input_alphas"] = list(SYNTHETIC_ALPHAS)
        info[m]["target_alphas"] = list(SYNTHETIC_ALPHAS)
    rng = np.random.default_rng(seed)
    pool = [{m: rng.integers(0, info[m]["vocab_size"],
                             size=info[m]["max_tokens"]).astype(np.int32)
             for m in MODS4} for _ in range(n)]
    return info, pool


def expand_modality_shards(path: str, mod_info: Dict, fallback_name: str,
                           split: bool = True) -> Dict:
    """'[rgb,depth]/.../shard-{000..195}.tar' -> aligned per-modality shard
    lists, each modality keyed by the registry entry whose `path` is its
    directory (run_training_egom2p.py:140-168).  split=True gives this
    process its share of the shards (train streams); split=False every
    shard (validation: every process reads the same stream)."""
    from egom2p_torch.core import distributed
    from egom2p_torch.data.tar_reader import braceexpand, shard_split

    m = re.search(r"\[([^\]]+)\]", path)
    per_mod = {}
    for mp in (m.group(1).split(",") if m else [""]):
        expanded = braceexpand(path.replace(f"[{m.group(1)}]", mp) if m else path)
        mod_key = next((k for k, v in mod_info.items() if v.get("path") == mp),
                       mp or fallback_name)
        per_mod[mod_key] = (shard_split(expanded, distributed.rank(), distributed.world_size())
                            if split else expanded)
    return per_mod


def _shard_factory(per_mod: Dict, n_repeats: int, buffer: int, seed: int,
                   s3_endpoint: Optional[str] = None):
    """The raw-sample stream of one dataset's shards: repeated, shuffled
    through a buffer; a forked worker passes its own seed and reads its
    share of the shards (run_training_egom2p.py:265-280)."""
    from egom2p_torch.data.tar_reader import (multi_tarfile_samples, repeated,
                                              shard_split, shuffled)
    pyr = random.Random(seed)

    def factory(seed=None, worker_id=0, num_workers=1):
        r = random.Random(seed) if seed is not None else pyr
        pm = per_mod
        if num_workers > 1 and min(len(v) for v in per_mod.values()) >= num_workers:
            pm = {k: shard_split(v, worker_id, num_workers) for k, v in per_mod.items()}
        return shuffled(repeated(lambda: multi_tarfile_samples(pm, s3_endpoint=s3_endpoint),
                                 n_repeats), buffer, r)

    return factory


def _hf_factory(dcfg: Dict, default_seed: int):
    """The raw-sample stream of a `huggingface` dataset
    (run_training_egom2p.py:246-256): a worker passes its own seed."""
    from egom2p_torch.data.hf_datasets import huggingface_samples

    def factory(seed=None):
        return huggingface_samples(dcfg["data_path"], split=dcfg.get("split", "train"),
                                   shuffle_buffer=dcfg.get("shuffle_buffer_load", 1000),
                                   seed=default_seed if seed is None else seed)

    return factory


def _text_tokenizer(args):
    """--text_tokenizer_path's WordPiece tokenizer (utils/text_tokenizer.py),
    or None (run_training_egom2p.py:192-195, 309-312)."""
    if not args.text_tokenizer_path:
        return None
    from egom2p_torch.utils.text_tokenizer import load_text_tokenizer
    return load_text_tokenizer(args.text_tokenizer_path)


def setup_data(args):
    """This process's train mixture loader and the sorted domains
    (run_training_egom2p.py:171-288): --synthetic_data's seeded pool of 256
    samples, or the data config's `train` datasets (this process's share
    of their shards).  Each process loads --batch_size x --accum_steps rows
    a batch, seeded seed + 7919 x rank."""
    from egom2p_torch.core import distributed
    from egom2p_torch.core.config import load_data_config, setup_sampling_mod_info
    from egom2p_torch.data.loader import DatasetStream, MixtureLoader
    from egom2p_torch.data.masking import TransferMasking, UnifiedMasking
    from egom2p_torch.data.modality_info import MODALITY_INFO

    text_tokenizer = _text_tokenizer(args)
    batch = args.batch_size * args.accum_steps
    seed = args.seed + distributed.rank() * 7919
    transfer = bool(args.input_domains) + bool(args.target_domains)
    if transfer == 1:
        raise ValueError("--input_domains and --target_domains go together")
    if args.synthetic_data:
        # a fixed pool, so that short smoke runs can demonstrably memorize
        info, pool = _synthetic_pool(args, args.seed, 256)
        if transfer:
            masking = TransferMasking(info, args.input_domains.split("-"),
                                      args.target_domains.split("-"), text_tokenizer)
        else:
            masking = UnifiedMasking(info, args.num_input_tokens, args.num_target_tokens,
                                     sampling_weights=[1.0] * 4, seed=args.seed,
                                     text_tokenizer=text_tokenizer)
        loader = MixtureLoader([DatasetStream(lambda: iter(pool), masking, name="synthetic")],
                               info, batch, seed=seed, num_workers=args.num_workers)
        return loader, sorted(MODS4)
    if not args.data_config:
        raise ValueError("--data_config is required without --synthetic_data")
    if transfer:
        print("--input_domains / --target_domains: the shard path keeps the data config's "
              "masking, as the JAX trainer does")
    train = load_data_config(args.data_config)["train"]
    streams, all_domains = [], set()
    for name, dcfg in train["datasets"].items():
        mod_info, sampling_weights = setup_sampling_mod_info(dcfg, MODALITY_INFO)
        all_domains |= set(mod_info)
        masking = UnifiedMasking(mod_info,
                                 dcfg.get("num_input_tokens") or args.num_input_tokens,
                                 dcfg.get("num_target_tokens") or args.num_target_tokens,
                                 sampling_weights=sampling_weights, seed=args.seed,
                                 text_tokenizer=text_tokenizer)
        if dcfg.get("type") == "huggingface":
            streams.append(DatasetStream(_hf_factory(dcfg, args.seed), masking, name=name))
            continue
        per_mod = expand_modality_shards(dcfg["data_path"], mod_info, name)
        factory = _shard_factory(per_mod, dcfg.get("wds_n_repeats", 1),
                                 dcfg.get("wds_shuffle_buffer_tar", 1000), args.seed,
                                 args.s3_data_endpoint)
        streams.append(DatasetStream(factory, masking, name=name))
    info_all = {m: MODALITY_INFO[m] for m in sorted(all_domains)}
    loader = MixtureLoader(streams, info_all, batch, seed=seed,
                           weights=train.get("weights"), num_workers=args.num_workers)
    return loader, sorted(all_domains)


def setup_val_data(args):
    """({name: factory}, {name: factory}) of the held-out validation and
    fixed-eval loaders (run_training_egom2p.py:291-389); each factory gives
    a fresh iterator over the same held-out samples, in global batches of
    --batch_size x processes rows that every process reads alike (every
    shard, split=False; run_eval takes this process's rows).  Validation draws
    token budgets as training does (masking seed + 9999); fixed eval pins
    each sample's budgets to (--fixed_eval_input_tokens,) * 2 and
    (--fixed_eval_target_tokens,) * 2 with the masking seed + 77777, so its
    batches are the same every epoch."""
    from egom2p_torch.core import distributed
    from egom2p_torch.core.config import load_data_config, setup_sampling_mod_info
    from egom2p_torch.data.loader import DatasetStream, MixtureLoader
    from egom2p_torch.data.masking import UnifiedMasking
    from egom2p_torch.data.modality_info import MODALITY_INFO
    from egom2p_torch.data.tar_reader import multi_tarfile_samples

    text_tokenizer = _text_tokenizer(args)
    batch = args.batch_size * distributed.world_size()

    def masking(mod_info, sampling_weights, fixed):
        if fixed:
            return UnifiedMasking(mod_info, (args.fixed_eval_input_tokens,) * 2,
                                  (args.fixed_eval_target_tokens,) * 2,
                                  sampling_weights=sampling_weights, seed=args.seed + 77777,
                                  text_tokenizer=text_tokenizer)
        return UnifiedMasking(mod_info, args.num_input_tokens, args.num_target_tokens,
                              sampling_weights=sampling_weights, seed=args.seed + 9999,
                              text_tokenizer=text_tokenizer)

    def make_factory(name, samples, mod_info, sampling_weights, fixed):
        def factory():
            stream = DatasetStream(samples, masking(mod_info, sampling_weights, fixed),
                                   name=name)
            return iter(MixtureLoader([stream], mod_info, batch,
                                      seed=args.seed + 31337, prefetch=1))
        return factory

    if args.synthetic_data:
        # a pool from another seed than the train pool's: held out
        info, pool = _synthetic_pool(args, args.seed + 500_000, 64)
        return ({"synthetic_val": make_factory("synthetic_val", lambda: iter(pool), info,
                                               [1.0] * 4, False)},
                {"synthetic_val": make_factory("synthetic_val", lambda: iter(pool), info,
                                               [1.0] * 4, True)})
    dc = load_data_config(args.data_config)
    if "val" not in dc:
        return {}, {}
    train_cfgs = dc.get("train", {}).get("datasets", {})
    val_factories, fixed_factories = {}, {}
    for name, dcfg in dc["val"]["datasets"].items():
        base = dict(train_cfgs.get(name, {}))
        base.update({k: v for k, v in dcfg.items() if v is not None})
        mod_info, sampling_weights = setup_sampling_mod_info(base, MODALITY_INFO)
        per_mod = expand_modality_shards(base["data_path"], mod_info, name, split=False)
        samples = lambda per_mod=per_mod: multi_tarfile_samples(  # noqa: E731
            per_mod, s3_endpoint=args.s3_data_endpoint)
        val_factories[name] = make_factory(name, samples, mod_info, sampling_weights, False)
        fixed_factories[name] = make_factory(name, samples, mod_info, sampling_weights, True)
    return val_factories, fixed_factories


def run_eval(factory, eval_step, prefix: str, eval_iters: int, keys, device) -> Dict[str, float]:
    """Mean of `eval_step`'s metrics over up to `eval_iters` global batches
    of a fresh iterator from `factory`, named `prefix` + key; {} without a
    batch (run_training_egom2p.py:634-666).  Each process evaluates its
    rows [r b, (r + 1) b) of every batch (eval_step gives the global
    batch's loss); every process enters every collective, and the means
    are reduced over the processes."""
    from egom2p_torch.core import distributed
    from egom2p_torch.data.loader import batch_to_device

    world, rank = distributed.world_size(), distributed.rank()
    accum, n = dict.fromkeys(keys, 0.0), 0
    it = factory()
    try:
        for _ in range(eval_iters):
            try:
                raw = next(it)
            except StopIteration:
                break
            b = next(iter(next(iter(raw.values())).values())).shape[0] // world
            mine = {m: {k: v[rank * b:(rank + 1) * b] for k, v in d.items()}
                    for m, d in raw.items()}
            for k, v in eval_step(batch_to_device(mine, device)).items():
                if k in accum:
                    accum[k] += float(v)
            n += 1
    finally:
        it.close()
    reduced = distributed.all_reduce_metrics({**accum, "__n": float(n)})
    n_all = reduced.pop("__n")
    return {f"{prefix}{k}": reduced[k] / n_all for k in keys} if n_all > 0 else {}


def _global_batch(args) -> int:
    from egom2p_torch.core import distributed
    return args.batch_size * distributed.world_size() * args.accum_steps


def lr_schedule(args) -> np.ndarray:
    """Epochs, warmup and the per-step LR from the token budgets and the
    global batch (reference: run_training_egom2p.py:446-469); sets
    args.epochs and args.warmup_steps where they are derived."""
    from egom2p_torch.core.schedules import (constant_scheduler, cosine_scheduler,
                                             inverse_sqrt_scheduler)

    global_batch = _global_batch(args)
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


def _batches(loader_it, to_device, device, n: int):
    """`n` batches of the loader, each as (its numpy batch, its copy on
    `device`): the loop's `data:` meter times this fetch and copy.  Each
    batch's live tokens are counted before the copy; under a profiler each
    fetch starts a unit of core/tracing.py."""
    for _ in range(n):
        with tracing.span("egom2p.data.fetch", unit=True):
            raw = next(loader_it)
        _count_live(raw)
        with tracing.span("egom2p.data.to_device"):
            batch = to_device(raw, device)
        yield raw, batch


def _count_live(raw) -> None:
    """A numpy batch's live input and target tokens (masks True where a slot
    is dead) into core/tracing.py's counters: summed over the rows, and the
    fullest row's, with the rows and the batch."""
    live_in = sum((~np.asarray(d["input_mask"], bool)).sum(axis=1) for d in raw.values())
    live_tgt = sum((~np.asarray(d["target_mask"], bool)).sum(axis=1) for d in raw.values())
    tracing.count("train.batches", 1)
    tracing.count("train.rows", len(live_in))
    tracing.count("train.live_inputs", int(live_in.sum()))
    tracing.count("train.live_targets", int(live_tgt.sum()))
    tracing.count("train.live_inputs_max", int(live_in.max()))
    tracing.count("train.live_targets_max", int(live_tgt.max()))


def _raise_open_files_limit() -> None:
    """Many-shard tar loading needs many open files (reference:
    run_training_egom2p.py:840-841)."""
    import resource
    try:
        _, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ValueError, OSError):
        pass


def _not_ported(args) -> None:
    if args.tensor_parallel > 1:
        raise NotImplementedError("--tensor_parallel: tensor parallelism is not ported")


def main(args, on_step: Optional[Callable[[int, Dict[str, float], float], None]] = None,
         on_epoch: Optional[Callable[[int, torch.nn.Module, Dict[str, float]], None]] = None):
    """Train; returns {"model", "optimizer", "step_seconds", "metrics"}.

    Under torchrun (or in a process group the caller formed) each process
    trains its share of the global batch (the module's docstring).
    `on_step(step, metrics, seconds)` runs after every step; `seconds` is
    the step's wall time between two device synchronizations.
    `on_epoch(epoch, model, eval_stats)` runs at the end of every epoch,
    after its checkpoint and evaluation."""
    from egom2p_torch.core import distributed
    from egom2p_torch.core.config import setup_run_name

    _not_ported(args)
    _raise_open_files_limit()
    setup_run_name(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: the trainer runs on CUDA devices; "
                           "pass --device cpu to train on the CPU")
    distributed.init_distributed_mode(args.device)
    device = (torch.device("cuda", distributed.local_rank()) if args.device == "cuda"
              else torch.device("cpu"))
    loader, domains = setup_data(args)
    # the forked workers start here, before the model's first CUDA call
    loader_it = iter(loader)
    try:
        with distributed.main_prints_only():
            return _train(args, device, loader_it, domains, on_step, on_epoch)
    finally:
        loader_it.close()


def _train(args, device, loader_it, domains, on_step, on_epoch):
    from egom2p_torch.core import distributed, fsdp, s3_sync
    from egom2p_torch.core.checkpoint import (auto_load_model, save_checkpoint, wait_for_saves,
                                              warm_start)
    from egom2p_torch.core.logging import JsonlLogger, MetricLogger, WandbLogger
    from egom2p_torch.core.optim import Optimizer, freeze_until, shared_params_mask
    from egom2p_torch.data.loader import batch_to_device
    from egom2p_torch.models.egom2p import create_model
    from egom2p_torch.train.egom2p_train import make_eval_step, make_train_step

    val_factories, fixed_factories = setup_val_data(args)
    if val_factories:
        print(f"val datasets: {sorted(val_factories)}")
    sched = lr_schedule(args)
    global_batch = _global_batch(args)
    tokens_per_sample = args.num_input_tokens + args.num_target_tokens
    niter_per_ep = max(args.epoch_size // global_batch, 1)
    print(f"device {device}, {distributed.world_size()} process(es), global batch "
          f"{global_batch}, {niter_per_ep} steps per epoch, {args.epochs} epochs, "
          f"first LR {sched[0]:.3e}")

    model_info = modality_info(args) if args.scaled_modalities else None
    model = create_model(args.model, domains, domains, modality_info=model_info, device=device,
                         num_register_tokens=args.num_register_tokens,
                         use_act_checkpoint=bool(args.use_act_checkpoint),
                         remat_policy=args.remat_policy)
    model.init_random_(torch.Generator(device=device).manual_seed(args.seed))
    print(f"model {args.model}: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params")
    if args.finetune:
        warm_start(model, args.finetune)
    # every process starts from rank 0's weights (a resume below loads the
    # same file on every rank)
    distributed.broadcast_module_(model)
    if args.fsdp:
        sharded = fsdp.shard_model(model)
        print(f"fsdp: {len(sharded.params)} tensors sharded over {sharded.world} process(es), "
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M parameters on this one")
    optimizer = Optimizer(model, sched, weight_decay=args.weight_decay,
                          betas=tuple(args.opt_betas), clip_grad=args.clip_grad)
    if args.frozen_model_epochs > 0:
        optimizer = freeze_until(args.frozen_model_epochs * niter_per_ep,
                                 shared_params_mask(model), optimizer, model)
    eval_steps = None
    eval_keys = ["loss"] + [f"loss_{m}" for m in sorted(model.out_domains)]
    shuffle = torch.Generator().manual_seed(args.seed + 1)
    jsonl = JsonlLogger(args.output_dir)
    wandb = WandbLogger(args) if args.log_wandb and distributed.is_main_process() else None

    step, start_epoch = 0, 0
    if args.auto_resume and args.s3_save_dir:
        # a machine with no local checkpoint resumes from the bucket's newest
        # (run_training_egom2p.py:511-521)
        if distributed.is_main_process():
            fetched = s3_sync.maybe_download_for_resume(args.output_dir, args.s3_save_dir,
                                                        endpoint_url=args.s3_endpoint)
            if fetched:
                print(f"downloaded {fetched} from {args.s3_save_dir}")
    if args.auto_resume:
        distributed.barrier()  # no process reads a checkpoint another is writing
        ckpt, path = auto_load_model(args.output_dir, model, optimizer)
        if ckpt is not None:
            step = ckpt["step"]
            start_epoch = step // niter_per_ep
            shuffle.set_state(ckpt["shuffle_rng"])
            print(f"resumed from {path} at step {step}, epoch {start_epoch}")
    step_fn = make_train_step(model, optimizer, args.num_input_tokens,
                              args.num_target_tokens, args.loss_type, args.accum_steps)
    # the checkpoint's args as the reference pickles them: a Namespace
    # naming the model and its domains
    ckpt_args = argparse.Namespace(**vars(args), in_domains=list(domains),
                                   out_domains=list(domains))

    step_seconds, history = [], []
    if args.synthetic_data:
        for _ in range(step):  # this process's seeded batches already trained on
            next(loader_it)
    profiler = _start_profile(args, device) if args.profile else None
    for epoch in range(start_epoch, args.epochs):
        logger = MetricLogger(print_freq=args.print_freq)
        for _, (raw, batch) in logger.log_every(
                _batches(loader_it, batch_to_device, device, niter_per_ep),
                header=f"Epoch [{epoch}]", total=niter_per_ep):
            _sync(device)
            t0 = time.perf_counter()
            with tracing.span("egom2p.train.step"):
                metrics = step_fn(batch, shuffle)
            _sync(device)
            seconds = time.perf_counter() - t0
            values = {k: float(v) for k, v in metrics.items()}
            if not np.isfinite(values["loss"]):
                # dump the offending batch and abort
                # (reference: run_training_egom2p.py:731-734)
                os.makedirs(args.output_dir, exist_ok=True)
                dump = os.path.join(args.output_dir, f"debug_mod_dict_rank{distributed.rank()}.npz"
                                    if distributed.world_size() > 1 else "debug_mod_dict.npz")
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
            if wandb is not None:
                wandb.log({**values, "tokens_seen": step * tokens_per_sample * global_batch},
                          step=step)
        if profiler is not None:
            profiler.stop()
            path = os.path.join(args.output_dir, "profile",
                                f"trace-rank{distributed.rank()}.json")
            profiler.export_chrome_trace(path)
            print(f"profile trace -> {path}")
            print(tracing.table(profiler))
            profiler = None
        jsonl.write({"epoch": epoch, "tokens_seen_B": step * tokens_per_sample
                     * global_batch / 1e9,
                     **{k: v.global_avg for k, v in logger.meters.items()}})
        if (epoch + 1) % args.save_ckpt_freq == 0 or epoch == args.epochs - 1:
            final = epoch == args.epochs - 1
            # periodic saves overlap the next steps; the final one blocks.
            # Every rank takes part (a sharded model's gathers), rank 0 writes
            blocking = final or not args.async_save
            path = save_checkpoint(args.output_dir, "final" if final else epoch,
                                   model, optimizer, step=step, epoch=epoch,
                                   args=ckpt_args, shuffle_rng=shuffle.get_state(),
                                   blocking=blocking, write=distributed.is_main_process())
            print(f"saved{'' if blocking else ' (async)'} {path}")
            if args.s3_save_dir and distributed.is_main_process():
                # after the write lands (run_training_egom2p.py:610-617)
                s3_sync.upload_after_save(path, args.s3_save_dir, blocking,
                                          endpoint_url=args.s3_endpoint)
        stats = {}
        if args.eval_freq and (epoch + 1) % args.eval_freq == 0 and val_factories:
            if eval_steps is None:
                eval_steps = (make_eval_step(model, args.num_input_tokens,
                                             args.num_target_tokens, args.loss_type),
                              make_eval_step(model, args.fixed_eval_input_tokens,
                                             args.fixed_eval_target_tokens, args.loss_type))
            for name, factory in val_factories.items():
                stats.update(run_eval(factory, eval_steps[0], f"val_{name}_",
                                      args.eval_iters, eval_keys, device))
            if args.fixed_eval:
                for name, factory in fixed_factories.items():
                    stats.update(run_eval(factory, eval_steps[1], f"fixed_eval_{name}_",
                                          args.eval_iters, eval_keys, device))
            if stats:
                print(f"Epoch [{epoch}] eval: "
                      + "  ".join(f"{k}: {v:.4f}" for k, v in stats.items()))
                jsonl.write({"epoch": epoch, **stats})
                if wandb is not None:
                    wandb.log(stats, step=step)
        if on_epoch is not None:
            on_epoch(epoch, model, stats)
    wait_for_saves()  # an in-flight periodic save, before the run ends
    if args.s3_save_dir:
        s3_sync.wait_for_uploads()
    distributed.barrier()  # and before any process goes on to read it
    if wandb is not None:
        wandb.finish()
    return {"model": model, "optimizer": optimizer, "step_seconds": step_seconds,
            "metrics": history}


def _start_profile(args, device):
    """A started torch.profiler over the first epoch's steps: host and, on
    CUDA, device activity (run_training_egom2p.py:558-561, 595-598); the
    program's spans and counters start afresh with it."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.join(args.output_dir, "profile"), exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    tracing.reset()
    prof.start()
    return prof


if __name__ == "__main__":
    main(get_args())
