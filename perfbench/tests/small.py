"""Small configurations of the benchmark's cells for CPU tests: the tiny
registry model, a small Cosmos topology, 4 x 4 token grids."""
from __future__ import annotations

import copy

from perfbench import core

TINY = {"registry_name": "egom2p_tiny_6e_6d_swiglu_nobias", "dim": 384, "encoder_depth": 6,
        "decoder_depth": 6, "num_heads": 6, "head_dim": 64, "mlp_hidden": 1024,
        "vocab_size": 64000}
SMALL_TOKENIZER = {"channels": 16, "channels_mult": [1, 2, 2], "num_res_blocks": 2,
                   "z_channels": 8, "patch_size": 4, "spatial_compression": 8,
                   "temporal_compression": 4, "levels": [8, 8, 8, 5, 5, 5]}
GRID = (5, 4, 4)


def small_config(name: str = "egom2p_base") -> dict:
    cfg = core.load_json("configs", f"{name}.json")
    cfg["model"] = dict(TINY)
    for m in ("tok_rgb", "tok_depth"):
        cfg["modalities"][m]["grid"] = list(GRID)
    cfg["tokenizer"] = dict(SMALL_TOKENIZER)
    return cfg


def patch_program(monkeypatch) -> None:
    """The program at the small sizes: its Cosmos topology and its two video
    modalities' grids."""
    from egom2p_torch.cli import eval_common
    from egom2p_torch.data.modality_info import MODALITY_INFO
    from egom2p_torch.tokenizers.cosmos.network import DiscreteVideoConfig
    t = SMALL_TOKENIZER
    monkeypatch.setattr(eval_common, "COSMOS_CONFIG", DiscreteVideoConfig(
        channels=t["channels"], channels_mult=tuple(t["channels_mult"]),
        z_channels=t["z_channels"]))
    n = GRID[0] * GRID[1] * GRID[2]
    for m in ("tok_rgb", "tok_depth"):
        info = copy.deepcopy(MODALITY_INFO[m])
        info["max_tokens"] = n
        info["embed_spec"] = {**info["embed_spec"], "grid": GRID}
        monkeypatch.setitem(MODALITY_INFO, m, info)
