"""Shared implementation of the port's eval entry points (rgb2depth,
depth2rgb, rgb2cam, rgb2gaze).

Port of egom2p_tpu/cli/eval_common.py:41-241 (reference:
eval_model_rgb2depth.py and its depth2rgb / rgb2cam / rgb2gaze diffs): load
the main model and the tokenizers the task needs, build the chained ROAR
schedule (temperature 0.01, CFG 2.0, top-p 0.8; 3 steps, 5 for rgb2gaze),
read each conditioning file (an mp4 tokenized by Cosmos, or pre-tokenized
rgb tokens in an npz), generate, and decode the target (an mp4, or a .npy
trajectory through the cam or gaze VQ-VAE).

Weights come from the reference's .pth files (core/checkpoint.py): the main
model is rebuilt from the args its checkpoint embeds; the Cosmos tokenizer
is a .pth, or an encoder.jit with its sibling decoder.jit; the cam and gaze
tokenizers are .pth files.  --smoke builds random weights from a
torch.Generator seeded with --seed instead.  A missing checkpoint without
--smoke raises: nothing falls back to random weights.  rgb2cam and rgb2gaze
load no Cosmos tokenizer (their conditioning is pre-tokenized).

Everything runs on the first CUDA device (--device cuda, the default), and
raises when there is none; --device cpu asks for the CPU.  Not ported yet:
--tensor_parallel (serving over several devices) and Orbax checkpoint
directories.
"""
from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from egom2p_torch.core import checkpoint, tracing
from egom2p_torch.data.modality_info import MODALITY_INFO
from egom2p_torch.data.video_ingest import read_video
from egom2p_torch.generate.decode import decode_targets
from egom2p_torch.generate.sampler import (GenerationSampler, init_empty_target_modality,
                                           init_full_input_modality)
from egom2p_torch.generate.schedules import build_chained_generation_schedules
from egom2p_torch.models.egom2p import create_model
from egom2p_torch.tokenizers.cosmos.network import (CausalDiscreteVideoTokenizer,
                                                    DV4x8x8_CONFIG)
from egom2p_torch.tokenizers.cosmos.video_api import CausalVideoTokenizer
from egom2p_torch.tokenizers.seq_vqvae import SeqTokenizer, seq_vqvae_from_config

MODS4 = ("tok_cam", "tok_depth", "tok_gaze", "tok_rgb")
# the tokenizers the entry points build (tests swap in smaller ones)
COSMOS_CONFIG = DV4x8x8_CONFIG
SEQ_CONFIG: Dict = {}  # seq_vqvae_from_config's widths; {} = the released ones


class Task(NamedTuple):
    cond: str      # conditioning modality
    target: str    # generated modality
    pattern: str   # the example files it reads
    steps: int     # ROAR decoding steps
    # decode_targets' key of the one tokenizer it loads: "tok_vid" (Cosmos:
    # tokenizes mp4 clips and decodes the video target), or "tok_cam" /
    # "tok_gaze" (the target's VQ-VAE; the conditioning is npz tokens)
    tokenizer: str


# (reference: eval_model_{rgb2depth,depth2rgb,rgb2cam,rgb2gaze}.py:15)
TASKS = {"rgb2depth": Task("tok_rgb", "tok_depth", "rgb2dep_*.mp4", 3, "tok_vid"),
         "depth2rgb": Task("tok_depth", "tok_rgb", "dep2rgb_*.mp4", 3, "tok_vid"),
         "rgb2cam": Task("tok_rgb", "tok_cam", "rgb2cam_*.npz", 3, "tok_cam"),
         "rgb2gaze": Task("tok_rgb", "tok_gaze", "rgb2gaze_*.npz", 5, "tok_gaze")}


def build_argparser(task: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=f"EgoM2P eval (PyTorch): {task}")
    p.add_argument("--ckpt", default="./ckpt/checkpoint-main.pth",
                   help="main model checkpoint (reference .pth)")
    p.add_argument("--video-tok-ckpt", default="./ckpt/cosmos-dv4x8x8/encoder.jit",
                   help="Cosmos DV tokenizer: encoder.jit (its sibling decoder.jit is "
                        "picked up) or a .pth of the whole network")
    p.add_argument("--cam-tok-ckpt", default="./ckpt/checkpoint-cam.pth",
                   help="cam VQ-VAE tokenizer (reference .pth), for rgb2cam")
    p.add_argument("--gaze-tok-ckpt", default="./ckpt/checkpoint-gaze.pth",
                   help="gaze VQ-VAE tokenizer (reference .pth), for rgb2gaze")
    p.add_argument("--model", default="egom2p_base_12e_12d_swiglu_nobias",
                   help="with --smoke; a checkpoint names its own model")
    p.add_argument("--data", default="example_data", help="directory with example clips")
    p.add_argument("--out", default="eval_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true",
                   help="random weights; exercises the full pipeline without checkpoints")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run; cuda raises when no CUDA device is found")
    return p


def resolve_device(name: str) -> torch.device:
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found: the eval runs on the first CUDA device; "
                               "pass --device cpu to run on the CPU")
        return torch.device("cuda", 0)
    return torch.device(name)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _require(path: str, what: str) -> None:
    if not os.path.exists(path):
        raise FileNotFoundError(f"{what} checkpoint {path} not found (pass --smoke for "
                                f"random weights)")


def load_main_model(args, device) -> torch.nn.Module:
    """EgoM2P on `device`, in eval mode: random --smoke weights over the four
    active modalities, or the checkpoint's weights on the model and domains
    its embedded args name (JAX eval_common.py:84-112)."""
    device = torch.device(device)
    if args.smoke:
        model = create_model(args.model, in_domains=MODS4, out_domains=MODS4, device=device)
        return model.init_random_(_generator(device, args.seed)).eval()
    _require(args.ckpt, "EgoM2P")
    name, in_domains, out_domains = args.model, MODS4, MODS4
    ckpt = checkpoint.load_pth(args.ckpt)  # read once: args and weights
    ck_args = ckpt.get("args")
    if ck_args is not None:
        name = getattr(ck_args, "model", name)
        in_domains = tuple(sorted(getattr(ck_args, "in_domains", MODS4)))
        out_domains = tuple(sorted(getattr(ck_args, "out_domains", MODS4)))
        print(f"model config from checkpoint args: {name}")
    model = create_model(name, in_domains=in_domains, out_domains=out_domains)
    return checkpoint.load_egom2p_pth(args.ckpt, model, ckpt).to(device).eval()


def load_video_tokenizer(args, device) -> CausalVideoTokenizer:
    """The Cosmos tokenizer (COSMOS_CONFIG) on `device`: --smoke random
    weights, a .pth of the whole network, or an encoder.jit with the
    decoder.jit beside it (JAX eval_common.py:120-138)."""
    device = torch.device(device)
    if args.smoke:
        net = CausalDiscreteVideoTokenizer(COSMOS_CONFIG).to(device)
        return CausalVideoTokenizer(net.init_random_(_generator(device, args.seed + 1)))
    path = args.video_tok_ckpt
    _require(path, "Cosmos")
    decoder = None
    base = os.path.basename(path)
    if "encoder" in base:
        sibling = os.path.join(os.path.dirname(path), base.replace("encoder", "decoder"))
        decoder = sibling if os.path.exists(sibling) else None
    return checkpoint.load_cosmos_dv_pth(path, decoder_path=decoder, cfg=COSMOS_CONFIG,
                                         device=device)


def load_seq_tokenizer(args, domain: str, device) -> SeqTokenizer:
    """The cam or gaze VQ-VAE (SEQ_CONFIG's widths) on `device`: --smoke
    random weights, or the reference .pth that --cam-tok-ckpt /
    --gaze-tok-ckpt names (JAX eval_common.py:141-156)."""
    device = torch.device(device)
    if args.smoke:
        return seq_vqvae_from_config(domain, _generator(device, args.seed + 2),
                                     device=device, **SEQ_CONFIG)
    path = args.cam_tok_ckpt if domain == "cam" else args.gaze_tok_ckpt
    _require(path, f"{domain} tokenizer")
    return checkpoint.load_seq_vqvae_pth(path, domain, device, **SEQ_CONFIG)


def roar_schedule(cond_domain: str, target_domain: str, steps: int = 3,
                  temperature: float = 0.01):
    """The eval scripts' chained ROAR schedule: every token of one target
    (its max_tokens) in `steps` steps, CFG 2.0 (temperature 0 for greedy
    checks)."""
    return build_chained_generation_schedules(
        cond_domains=[cond_domain], target_domains=[target_domain],
        tokens_per_target=[MODALITY_INFO[target_domain]["max_tokens"]],
        autoregression_schemes=["roar"], decoding_steps=[steps],
        token_decoding_schedules=["linear"], temps=[temperature],
        temp_schedules=["constant"], cfg_scales=[2.0], cfg_schedules=["constant"],
        cfg_grow_conditioning=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_tokens(cond, sampler, schedule, cond_domain: str, target_domain: str,
               seed: int = 0) -> Tuple[Dict, float]:
    """Conditioning tokens (B, n) (numpy, or a tensor on the device) -> the
    generated mod dict, and the seconds of the generate."""
    _sync(sampler.device)
    t0 = time.perf_counter()
    sample = {cond_domain: {"tensor": cond}}
    init_full_input_modality(sample, MODALITY_INFO, cond_domain)
    init_empty_target_modality(sample, MODALITY_INFO, target_domain, cond.shape[0],
                               MODALITY_INFO[target_domain]["max_tokens"])
    with tracing.span("egom2p.generate"):
        out = sampler.generate(sample, schedule, top_p=0.8, top_k=0.0, seed=seed)
    _sync(sampler.device)
    return out, time.perf_counter() - t0


def run_clip(video, sampler, tokenizer, schedule, cond_domain: str, target_domain: str,
             seed: int = 0) -> Tuple[Dict, Dict[str, float]]:
    """One batch of uint8 clips (B, T, 256, 256, 3) -> the generated mod
    dict, and the seconds of its tokenize and generate.  The call is one
    unit of core/tracing.py (the caller's decode of its tokens joins it)."""
    device = tokenizer.device
    with tracing.span("egom2p.clip", unit=True):
        _sync(device)
        t0 = time.perf_counter()
        with tracing.span("egom2p.tokenize"):
            cond = tokenizer.forward(video, device_out=True)  # (B, 5, 32, 32)
        cond = cond.reshape(cond.shape[0], -1)
        _sync(device)
        tokenize_s = time.perf_counter() - t0
        out, generate_s = run_tokens(cond, sampler, schedule, cond_domain, target_domain, seed)
    return out, {"tokenize_s": tokenize_s, "generate_s": generate_s}


def read_npz_tokens(path: str, domain: str) -> np.ndarray:
    """Pre-tokenized conditioning: the npz's `arr_0` -> (1, n) int32, n the
    modality's max_tokens (5120 rgb tokens for rgb2cam / rgb2gaze)."""
    with np.load(path) as f:
        tokens = f["arr_0"]
    n = MODALITY_INFO[domain]["max_tokens"]
    if tokens.size != n:
        raise ValueError(f"{path}: {tokens.size} tokens, {domain} takes {n}")
    return tokens.reshape(1, n).astype(np.int32)


def load_task(task: str, args):
    """The sampler over the main model, the task's tokenizer (a dict under
    its decode_targets key) and the task's ROAR schedule, on the device
    --device names."""
    device = resolve_device(args.device)
    t = TASKS[task]
    path, what, load = {
        "tok_vid": (args.video_tok_ckpt, "Cosmos", load_video_tokenizer),
        "tok_cam": (args.cam_tok_ckpt, "cam tokenizer",
                    lambda a, d: load_seq_tokenizer(a, "cam", d)),
        "tok_gaze": (args.gaze_tok_ckpt, "gaze tokenizer",
                     lambda a, d: load_seq_tokenizer(a, "gaze", d))}[t.tokenizer]
    if not args.smoke:  # every checkpoint the task reads, before any is loaded
        _require(args.ckpt, "EgoM2P")
        _require(path, what)
    sampler = GenerationSampler(load_main_model(args, device))
    tokenizers = {t.tokenizer: load(args, device)}
    return sampler, tokenizers, roar_schedule(t.cond, t.target, t.steps)


def run_task(task: str, args) -> List[Dict]:
    """Run one eval task over the matching example files, one clip at a
    time; returns per-file records of seconds and outputs."""
    t = TASKS[task]
    files = sorted(glob.glob(os.path.join(args.data, t.pattern)))
    if not files:
        raise FileNotFoundError(f"no inputs matching {t.pattern} under {args.data}")
    sampler, tokenizers, schedule = load_task(task, args)

    records = []
    for path in files:
        fname = os.path.basename(path)
        print(fname)
        if t.tokenizer == "tok_vid":
            video = read_video(path, out_size=256)[None]  # already 8 fps, 256 px
            out, seconds = run_clip(video, sampler, tokenizers["tok_vid"], schedule, t.cond,
                                    t.target, seed=args.seed)
        else:
            t0 = time.perf_counter()
            cond = read_npz_tokens(path, t.cond)
            tokenize_s = time.perf_counter() - t0
            out, generate_s = run_tokens(cond, sampler, schedule, t.cond, t.target,
                                         seed=args.seed)
            seconds = {"tokenize_s": tokenize_s, "generate_s": generate_s}
        t0 = time.perf_counter()
        outputs = decode_targets(fname, out, tokenizers, [t.target],
                                 name=os.path.join(args.out, task))
        seconds["decode_s"] = time.perf_counter() - t0
        records.append({"file": fname, **seconds, "outputs": outputs})
        print(f"  tokenize {seconds['tokenize_s']:.2f}s generate {seconds['generate_s']:.2f}s "
              f"decode {seconds['decode_s']:.2f}s")
    return records
