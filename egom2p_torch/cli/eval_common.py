"""Shared implementation of the port's eval entry points (rgb2depth,
depth2rgb).

Port of egom2p_tpu/cli/eval_common.py:41-241 (reference:
eval_model_rgb2depth.py and its depth2rgb diff): load the Cosmos video
tokenizer and the main model, build the chained ROAR schedule (3 steps,
temperature 0.01, CFG 2.0, top-p 0.8), tokenize each conditioning clip,
generate, and decode the target to an mp4.

Weights come from the reference's .pth files (core/checkpoint.py): the main
model is rebuilt from the args its checkpoint embeds; the tokenizer is a
Cosmos .pth, or an encoder.jit with its sibling decoder.jit.  --smoke builds
random weights from a torch.Generator seeded with --seed instead.  A missing
checkpoint without --smoke raises: nothing falls back to random weights.

Everything runs on the first CUDA device (--device cuda, the default), and
raises when there is none; --device cpu asks for the CPU.  Not ported yet:
--tensor_parallel (serving over several devices), and the rgb2cam /
rgb2gaze tasks with their cam and gaze tokenizers.
"""
from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict, List, Tuple

import torch

from egom2p_torch.core import checkpoint
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

MODS4 = ("tok_cam", "tok_depth", "tok_gaze", "tok_rgb")
# the tokenizer the entry points build (tests swap in a smaller one)
COSMOS_CONFIG = DV4x8x8_CONFIG
VIDEO_TOKENS = 5120  # a 5 x 32 x 32 grid

# task -> (conditioning, target, the example files it reads; the reference's
# eval scripts read mp4s for video conditioning)
TASKS = {"rgb2depth": ("tok_rgb", "tok_depth", "rgb2dep_*.mp4"),
         "depth2rgb": ("tok_depth", "tok_rgb", "dep2rgb_*.mp4")}


def build_argparser(task: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=f"EgoM2P eval (PyTorch): {task}")
    p.add_argument("--ckpt", default="./ckpt/checkpoint-main.pth",
                   help="main model checkpoint (reference .pth)")
    p.add_argument("--video-tok-ckpt", default="./ckpt/cosmos-dv4x8x8/encoder.jit",
                   help="Cosmos DV tokenizer: encoder.jit (its sibling decoder.jit is "
                        "picked up) or a .pth of the whole network")
    p.add_argument("--cam-tok-ckpt", default="./ckpt/checkpoint-cam",
                   help="for rgb2cam, not ported yet")
    p.add_argument("--gaze-tok-ckpt", default="./ckpt/checkpoint-gaze",
                   help="for rgb2gaze, not ported yet")
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


def video_schedule(cond_domain: str, target_domain: str, temperature: float = 0.01):
    """The eval scripts' chained ROAR schedule: one video target, 3 steps,
    CFG 2.0 (temperature 0 for greedy checks)."""
    return build_chained_generation_schedules(
        cond_domains=[cond_domain], target_domains=[target_domain],
        tokens_per_target=[VIDEO_TOKENS], autoregression_schemes=["roar"],
        decoding_steps=[3], token_decoding_schedules=["linear"],
        temps=[temperature], temp_schedules=["constant"], cfg_scales=[2.0],
        cfg_schedules=["constant"], cfg_grow_conditioning=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_clip(video, sampler, tokenizer, schedule, cond_domain: str, target_domain: str,
             seed: int = 0) -> Tuple[Dict, Dict[str, float]]:
    """One batch of uint8 clips (B, T, 256, 256, 3) -> the generated mod
    dict, and the seconds of its tokenize and generate."""
    device = tokenizer.device
    _sync(device)
    t0 = time.perf_counter()
    cond = tokenizer.forward(video, device_out=True)  # (B, 5, 32, 32)
    cond = cond.reshape(cond.shape[0], -1)
    _sync(device)
    t1 = time.perf_counter()
    sample = {cond_domain: {"tensor": cond}}
    init_full_input_modality(sample, MODALITY_INFO, cond_domain)
    init_empty_target_modality(sample, MODALITY_INFO, target_domain, cond.shape[0], VIDEO_TOKENS)
    out = sampler.generate(sample, schedule, top_p=0.8, top_k=0.0, seed=seed)
    _sync(device)
    return out, {"tokenize_s": t1 - t0, "generate_s": time.perf_counter() - t1}


def load_task(task: str, args):
    """The sampler over the main model, the video tokenizer and the task's
    ROAR schedule, on the device --device names."""
    device = resolve_device(args.device)
    cond_domain, target_domain, _ = TASKS[task]
    return (GenerationSampler(load_main_model(args, device)), load_video_tokenizer(args, device),
            video_schedule(cond_domain, target_domain))


def run_task(task: str, args) -> List[Dict]:
    """Run one video eval task over the matching example files, one clip at a
    time; returns per-file records of seconds and outputs."""
    cond_domain, target_domain, pattern = TASKS[task]
    files = sorted(glob.glob(os.path.join(args.data, pattern)))
    if not files:
        raise FileNotFoundError(f"no inputs matching {pattern} under {args.data}")
    sampler, tokenizer, schedule = load_task(task, args)

    records = []
    for path in files:
        fname = os.path.basename(path)
        print(fname)
        video = read_video(path, out_size=256)[None]  # already 8 fps, 256 px
        out, seconds = run_clip(video, sampler, tokenizer, schedule, cond_domain,
                                target_domain, seed=args.seed)
        t0 = time.perf_counter()
        outputs = decode_targets(fname, out, {"tok_vid": tokenizer}, [target_domain],
                                 name=os.path.join(args.out, task))
        seconds["decode_s"] = time.perf_counter() - t0
        records.append({"file": fname, **seconds, "outputs": outputs})
        print(f"  tokenize {seconds['tokenize_s']:.2f}s generate {seconds['generate_s']:.2f}s "
              f"decode {seconds['decode_s']:.2f}s")
    return records
