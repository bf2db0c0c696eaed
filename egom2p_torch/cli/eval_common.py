"""Model and tokenizer loading for the port's entry points.

Port of `load_main_model` / `load_video_tokenizer` from
egom2p_tpu/cli/eval_common.py:84-138.  `--smoke` builds random weights from a
`torch.Generator` seeded with `--seed`, on the requested device; loading
checkpoints waits until checkpoints are in the repository.
"""
from __future__ import annotations

import torch

from egom2p_torch.models.egom2p import create_model
from egom2p_torch.tokenizers.cosmos.network import (CausalDiscreteVideoTokenizer,
                                                    DV4x8x8_CONFIG)
from egom2p_torch.tokenizers.cosmos.video_api import CausalVideoTokenizer

MODS4 = ("tok_cam", "tok_depth", "tok_gaze", "tok_rgb")


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _require_smoke(args, what: str):
    if not args.smoke:
        raise NotImplementedError(
            f"loading {what} checkpoints is not ported yet: pass --smoke "
            f"for random weights")


def load_main_model(args, device) -> torch.nn.Module:
    """EgoM2P over the four active modalities, on `device`, in eval mode."""
    _require_smoke(args, "EgoM2P")
    device = torch.device(device)
    model = create_model(args.model, in_domains=MODS4, out_domains=MODS4, device=device)
    return model.init_random_(_generator(device, args.seed)).eval()


def load_video_tokenizer(args, device) -> CausalVideoTokenizer:
    """The Cosmos DV4x8x8 tokenizer (encode half) on `device`, bf16 compute."""
    _require_smoke(args, "Cosmos")
    device = torch.device(device)
    net = CausalDiscreteVideoTokenizer(DV4x8x8_CONFIG).to(device)
    net.init_random_(_generator(device, args.seed + 1))
    return CausalVideoTokenizer(net, torch.bfloat16)
