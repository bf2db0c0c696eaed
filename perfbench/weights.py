"""Seeded weights and inputs, made on the device from the run's seed, handed
alike to the program and to the reference.

A weight set is one `torch.randn` draw over every leaf in sorted-name order
from a generator on the device, then scaled per leaf by the family's init
rule; the same names, shapes and seed give the same tensors on every call.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
import torch.nn.functional as F

SEED_MASK = (1 << 63) - 1


def sub_seed(seed: int, stream: int) -> int:
    """A derived seed for one of the run's random streams."""
    return (seed * 1_000_003 + stream * 7_919) & SEED_MASK


def _egom2p_std(name: str, shape) -> float:
    """EgoM2P's init: normal 0.02 for embeddings and the mask token,
    lecun-normal (fan_in^-0.5) for products; 1 for norms, 0 for biases."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("mod_emb", "mask_token", "register_tokens") or name.endswith("token_emb.weight"):
        return 0.02
    if leaf == "bias":
        return 0.0
    if len(shape) == 1:
        return -1.0  # a norm's scale
    return shape[1] ** -0.5


def _cosmos_std(name: str, shape) -> float:
    """Cosmos's init: lecun-normal convs, zero biases, unit norms."""
    if name.endswith("norm.weight"):
        return -1.0
    if name.endswith("bias"):
        return 0.0
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    return fan_in ** -0.5


RULES = {"egom2p": _egom2p_std, "cosmos": _cosmos_std}


def draw(shapes: Dict[str, Tuple[int, ...]], seed: int, family: str,
         device) -> Dict[str, torch.Tensor]:
    """name -> fp32 tensor on `device` for every name in `shapes`."""
    rule = RULES[family]
    names = sorted(shapes)
    sizes = [int(torch.Size(shapes[n]).numel()) for n in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, n in zip(names, sizes):
        std = rule(name, shapes[name])
        t = flat[off:off + n].view(shapes[name])
        if std < 0:
            out[name] = torch.ones_like(t)
        elif std == 0:
            out[name] = torch.zeros_like(t)
        else:
            out[name] = t * std
        off += n
    del flat
    return out


@torch.no_grad()
def fill_module_(named: Iterable[Tuple[str, torch.nn.Parameter]], seed: int, family: str) -> None:
    """Overwrite a module's parameters with the seeded set."""
    named = list(named)
    device = named[0][1].device
    values = draw({n: tuple(p.shape) for n, p in named}, seed, family, device)
    for n, p in named:
        p.copy_(values.pop(n))


def clip_pool(seed: int, count: int, shape, device, chunk: int = 8) -> torch.Tensor:
    """`count` uint8 clips of `shape` (T, H, W, 3): smooth random fields (a
    coarse grid upsampled in space and time) plus fine noise, made on
    `device` and returned in pinned host memory (a CPU tensor off the card)."""
    T, H, W, C = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pinned = torch.cuda.is_available() and torch.device(device).type == "cuda"
    out = torch.empty((count, T, H, W, C), dtype=torch.uint8, pin_memory=pinned)
    for i in range(0, count, chunk):
        n = min(chunk, count - i)
        coarse = torch.rand((n, C, max(T // 4, 1), max(H // 16, 1), max(W // 16, 1)),
                            generator=gen, device=device)
        smooth = F.interpolate(coarse, size=(T, H, W), mode="trilinear", align_corners=False)
        noise = torch.rand((n, C, T, H, W), generator=gen, device=device)
        video = (smooth * 0.85 + noise * 0.15).clamp(0, 1) * 255.0
        out[i:i + n].copy_(video.permute(0, 2, 3, 4, 1).round().to(torch.uint8))
    return out
