"""Cosmos causal discrete video tokenizer (DV, FSQ): the encode half.

Port of `EncoderFactorized` and `CausalDiscreteVideoTokenizer.encode` from
egom2p_tpu/tokenizers/cosmos/network.py (reference:
cosmos_tokenizer/networks/discrete_video.py:33-145,
cosmos_tokenizer/modules/layers3d.py:731-884).  EgoM2P uses
Cosmos-0.1-Tokenizer-DV4x8x8: a 17-frame 256x256 clip maps to a 5x32x32 grid
of 64k-FSQ tokens.  Submodule names follow the reference torch keys
(`encoder.down.0.block.1.conv1.0.conv3d.weight`, `encoder.mid.attn_1.0.q...`).

Not ported yet: the decoder (DecoderFactorized, post_quant_conv,
decode_code) and the non-factorized BASE encoder.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import nn

from egom2p_torch.ops.fsq import FSQ
from egom2p_torch.ops.wavelet import patch3d_haar
from egom2p_torch.tokenizers.cosmos.layers import (CausalAttnBlock, CausalConv3d,
                                                   CausalHybridDownsample3d,
                                                   CausalNormalize,
                                                   CausalResnetBlockFactorized3d,
                                                   CausalTemporalAttnBlock,
                                                   _factorized_conv, nonlinearity)


@dataclasses.dataclass(frozen=True)
class DiscreteVideoConfig:
    """(reference: cosmos_tokenizer/networks/configs.py:123-146, adjusted to
    the DV4x8x8 checkpoint's compression rates)."""
    channels: int = 128
    channels_mult: Tuple[int, ...] = (2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (32,)
    in_channels: int = 3
    resolution: int = 1024
    patch_size: int = 4
    z_channels: int = 16
    z_factor: int = 1
    spatial_compression: int = 8
    temporal_compression: int = 4
    embedding_dim: int = 6
    levels: Tuple[int, ...] = (8, 8, 8, 5, 5, 5)


DV4x8x8_CONFIG = DiscreteVideoConfig()


def _attn_pair(channels: int) -> nn.Sequential:
    """Spatial then causal temporal attention (the reference's factorized
    attention slot: `.0` spatial, `.1` temporal)."""
    return nn.Sequential(CausalAttnBlock(channels, 1), CausalTemporalAttnBlock(channels, 1))


class EncoderFactorized(nn.Module):
    """(reference: layers3d.py:731-884).  NCTHW in and out; the input is
    already Haar-patched."""

    def __init__(self, cfg: DiscreteVideoConfig):
        super().__init__()
        n_levels = len(cfg.channels_mult)
        log2_patch = int(math.log2(cfg.patch_size))
        num_spatial_downs = int(math.log2(cfg.spatial_compression)) - log2_patch
        num_temporal_downs = int(math.log2(cfg.temporal_compression)) - log2_patch
        in_ch = cfg.in_channels * cfg.patch_size ** 3

        self.conv_in = _factorized_conv(in_ch, cfg.channels)
        curr_res = cfg.resolution // cfg.patch_size
        block_in = cfg.channels
        self.down = nn.ModuleList()
        for i_level in range(n_levels):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_out = cfg.channels * cfg.channels_mult[i_level]
            for _ in range(cfg.num_res_blocks):
                level.block.append(CausalResnetBlockFactorized3d(block_in, block_out, 1))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(_attn_pair(block_in))
            if i_level != n_levels - 1:
                level.downsample = CausalHybridDownsample3d(
                    block_in, spatial_down=i_level < num_spatial_downs,
                    temporal_down=i_level < num_temporal_downs)
                curr_res //= 2
            self.down.append(level)

        self.mid = nn.Module()
        self.mid.block_1 = CausalResnetBlockFactorized3d(block_in, block_in, 1)
        self.mid.attn_1 = _attn_pair(block_in)
        self.mid.block_2 = CausalResnetBlockFactorized3d(block_in, block_in, 1)
        self.norm_out = CausalNormalize(block_in, 1)
        self.conv_out = _factorized_conv(block_in, cfg.z_factor * cfg.z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn) > 0:
                    h = level.attn[i_block](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(nonlinearity(self.norm_out(h)))


class CausalDiscreteVideoTokenizer(nn.Module):
    """encoder -> quant_conv -> FSQ (reference: networks/discrete_video.py:33-145)."""

    def __init__(self, cfg: DiscreteVideoConfig = DV4x8x8_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.encoder = EncoderFactorized(cfg)
        self.quant_conv = CausalConv3d(cfg.z_factor * cfg.z_channels, cfg.embedding_dim,
                                       (1, 1, 1), padding=0)
        self.quantizer = FSQ(cfg.levels)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "CausalDiscreteVideoTokenizer":
        """Random weights from `generator` (on the module's device):
        lecun-normal convs (std fan_in^-0.5), zero biases, unit norms."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        return self

    def encode_latent(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, H, W, 3) in [-1, 1] -> pre-FSQ latent (B, t, h, w, 6)."""
        h = patch3d_haar(x, self.cfg.patch_size).permute(0, 4, 1, 2, 3)
        h = self.quant_conv(self.encoder(h))
        return h.permute(0, 2, 3, 4, 1)

    def encode(self, x: torch.Tensor):
        """x: (B, T, H, W, 3) in [-1, 1] -> (indices (B, t, h, w) int32,
        codes (B, t, h, w, 6) fp32)."""
        return self.quantizer(self.encode_latent(x).float())
