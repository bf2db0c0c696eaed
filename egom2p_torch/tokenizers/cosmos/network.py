"""Cosmos causal video tokenizers: the discrete (DV, FSQ) and continuous
(CV, AE / VAE) networks, each with the FACTORIZED or the BASE encoder and
decoder.

Port of egom2p_tpu/tokenizers/cosmos/network.py (reference:
cosmos_tokenizer/networks/discrete_video.py:33-145, continuous_video.py:
31-118, cosmos_tokenizer/modules/layers3d.py:476-1040).  EgoM2P uses
Cosmos-0.1-Tokenizer-DV4x8x8: a 17-frame 256x256 clip maps to a 5x32x32 grid
of 64k-FSQ tokens, and the grid decodes back to 17 frames.  The BASE network
(`encoder="BASE"`) patches each frame in 2-D, runs full 3x3x3 resnet blocks
and strided spatio-temporal downsamples, and ends its encoder with a
temporal average pool (its decoder with a temporal repeat).  Submodule names
follow the reference torch keys (`encoder.down.0.block.1.conv1.0.conv3d.weight`,
`encoder.mid.attn_1.0.q...`, `decoder.up.2.upsample.conv2.conv3d.weight`;
BASE: `encoder.conv_in.conv3d.weight`, `encoder.down.0.block.0.conv1...`,
`encoder.down.0.downsample.conv...`, `decoder.up.1.upsample.conv...`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from egom2p_torch.ops.fsq import FSQ
from egom2p_torch.ops.wavelet import (patch2d_haar, patch2d_rearrange, patch3d_haar,
                                      patch3d_rearrange, unpatch2d_haar, unpatch2d_rearrange,
                                      unpatch3d_haar, unpatch3d_rearrange)
from egom2p_torch.tokenizers.cosmos.distributions import (gaussian_distribution,
                                                          identity_distribution)
from egom2p_torch.tokenizers.cosmos.layers import (CausalAttnBlock, CausalConv3d,
                                                   CausalDownsample3d,
                                                   CausalHybridDownsample3d,
                                                   CausalHybridUpsample3d,
                                                   CausalNormalize, CausalResnetBlock3d,
                                                   CausalResnetBlockFactorized3d,
                                                   CausalTemporalAttnBlock, CausalUpsample3d,
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
    out_channels: int = 3
    resolution: int = 1024
    patch_size: int = 4
    patch_method: str = "haar"  # or "rearrange"
    z_channels: int = 16
    z_factor: int = 1
    num_groups: int = 1         # the BASE network's GroupNorm groups
    legacy_mode: bool = False
    spatial_compression: int = 8
    temporal_compression: int = 4
    embedding_dim: int = 6
    levels: Tuple[int, ...] = (8, 8, 8, 5, 5, 5)
    encoder: str = "FACTORIZED"  # or "BASE" (reference: Encoder3DType)
    decoder: str = "FACTORIZED"


DV4x8x8_CONFIG = DiscreteVideoConfig()
# the public Cosmos DV8x16x16 variant (reference: configs.py:123-146 verbatim)
DV8x16x16_CONFIG = DiscreteVideoConfig(spatial_compression=16, temporal_compression=8)


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


class DecoderFactorized(nn.Module):
    """(reference: layers3d.py:887-1040).  NCTHW in and out; the output is
    still Haar-patched.  `up[i]` is level i, run from the last level down."""

    def __init__(self, cfg: DiscreteVideoConfig):
        super().__init__()
        n_levels = len(cfg.channels_mult)
        log2_patch = int(math.log2(cfg.patch_size))
        num_spatial_ups = int(math.log2(cfg.spatial_compression)) - log2_patch
        num_temporal_ups = int(math.log2(cfg.temporal_compression)) - log2_patch
        block_in = cfg.channels * cfg.channels_mult[-1]

        self.conv_in = _factorized_conv(cfg.z_channels, block_in)
        self.mid = nn.Module()
        self.mid.block_1 = CausalResnetBlockFactorized3d(block_in, block_in, 1)
        self.mid.attn_1 = _attn_pair(block_in)
        self.mid.block_2 = CausalResnetBlockFactorized3d(block_in, block_in, 1)

        levels = [None] * n_levels
        for i_level in reversed(range(n_levels)):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()  # attn_resolutions never match here, as in JAX
            block_out = cfg.channels * cfg.channels_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(CausalResnetBlockFactorized3d(block_in, block_out, 1))
                block_in = block_out
            if i_level != 0:
                # layer-index correspondence with the encoder's downsampling
                # (reference: layers3d.py:992-1008)
                i_level_reverse = n_levels - i_level - 1
                if cfg.legacy_mode:
                    temporal_up = i_level_reverse < num_temporal_ups
                else:
                    temporal_up = 0 < i_level_reverse < num_temporal_ups + 1
                spatial_up = temporal_up or (i_level_reverse < num_spatial_ups
                                             and num_spatial_ups > num_temporal_ups)
                level.upsample = CausalHybridUpsample3d(block_in, spatial_up=spatial_up,
                                                        temporal_up=temporal_up)
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = CausalNormalize(block_in, 1)
        self.conv_out = _factorized_conv(block_in, cfg.out_channels * cfg.patch_size ** 3)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(nonlinearity(self.norm_out(h)))


class EncoderBase(nn.Module):
    """Non-factorized MagViT2 encoder: full 3x3x3 resnet blocks, strided
    spatio-temporal downsamples and a final temporal average pool
    (reference: layers3d.py:476-601).  NCTHW in and out; the input is
    already patched in 2-D, frame by frame."""

    def __init__(self, cfg: DiscreteVideoConfig):
        super().__init__()
        n_levels, ng = len(cfg.channels_mult), cfg.num_groups
        self.conv_in = CausalConv3d(cfg.in_channels * cfg.patch_size ** 2, cfg.channels,
                                    (3, 3, 3), padding=1)
        curr_res = cfg.resolution // cfg.patch_size
        block_in = cfg.channels
        self.down = nn.ModuleList()
        for i_level in range(n_levels):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_out = cfg.channels * cfg.channels_mult[i_level]
            for _ in range(cfg.num_res_blocks):
                level.block.append(CausalResnetBlock3d(block_in, block_out, ng))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(CausalAttnBlock(block_in, ng))
            if i_level != n_levels - 1:
                level.downsample = CausalDownsample3d(block_in)
                curr_res //= 2
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = CausalResnetBlock3d(block_in, block_in, ng)
        self.mid.attn_1 = CausalAttnBlock(block_in, ng)
        self.mid.block_2 = CausalResnetBlock3d(block_in, block_in, ng)
        self.norm_out = CausalNormalize(block_in, ng)
        self.conv_out = CausalConv3d(block_in, cfg.z_factor * cfg.z_channels, (3, 3, 3),
                                     padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn) > 0:
                    h = level.attn[i_block](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        # the final temporal average-pool downsample (layers3d.py:578-589)
        time_factor = 2 if h.shape[2] > 1 else 1
        h = F.avg_pool3d(torch.cat([h[:, :, :1], h], dim=2), (time_factor, 1, 1), (2, 1, 1))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(nonlinearity(self.norm_out(h)))


class DecoderBase(nn.Module):
    """(reference: layers3d.py:604-728).  NCTHW in and out; the output is
    still patched in 2-D.  `up[i]` is level i, run from the last level down;
    level 0 ends with a temporal repeat."""

    def __init__(self, cfg: DiscreteVideoConfig):
        super().__init__()
        n_levels, ng = len(cfg.channels_mult), cfg.num_groups
        block_in = cfg.channels * cfg.channels_mult[-1]
        self.conv_in = CausalConv3d(cfg.z_channels, block_in, (3, 3, 3), padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = CausalResnetBlock3d(block_in, block_in, ng)
        self.mid.attn_1 = CausalAttnBlock(block_in, ng)
        self.mid.block_2 = CausalResnetBlock3d(block_in, block_in, ng)
        levels = [None] * n_levels
        for i_level in reversed(range(n_levels)):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_out = cfg.channels * cfg.channels_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(CausalResnetBlock3d(block_in, block_out, ng))
                block_in = block_out
            if i_level != 0:
                level.upsample = CausalUpsample3d(block_in)
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = CausalNormalize(block_in, ng)
        self.conv_out = CausalConv3d(block_in, cfg.out_channels * cfg.patch_size ** 2,
                                     (3, 3, 3), padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        # the final temporal repeat upsample (layers3d.py:716-722)
        time_factor = 2 if h.shape[2] > 1 else 1
        h = h.repeat_interleave(time_factor, dim=2)[:, :, time_factor - 1:]
        return self.conv_out(nonlinearity(self.norm_out(h)))


_ENCODERS = {"FACTORIZED": EncoderFactorized, "BASE": EncoderBase}
_DECODERS = {"FACTORIZED": DecoderFactorized, "BASE": DecoderBase}


class _VideoNetwork(nn.Module):
    """What the discrete and continuous video networks share: the patcher
    the encoder type asks for (3-D for FACTORIZED, per frame in 2-D for
    BASE; Haar or rearrange), the network's NCTHW layout inside, and the
    random init."""

    cfg: DiscreteVideoConfig

    def _patch(self, x: torch.Tensor) -> torch.Tensor:
        haar = self.cfg.patch_method == "haar"
        if self.cfg.encoder == "BASE":
            fn = patch2d_haar if haar else patch2d_rearrange
        else:
            fn = patch3d_haar if haar else patch3d_rearrange
        return fn(x, self.cfg.patch_size)

    def _unpatch(self, h: torch.Tensor) -> torch.Tensor:
        haar = self.cfg.patch_method == "haar"
        if self.cfg.decoder == "BASE":
            fn = unpatch2d_haar if haar else unpatch2d_rearrange
        else:
            fn = unpatch3d_haar if haar else unpatch3d_rearrange
        return fn(h, self.cfg.patch_size)

    def _encode_nc(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, H, W, 3) -> quant_conv's output, channel-last.  The
        patch runs in x's dtype (bf16 on the tokenizers' default path); from
        conv_in on the network computes in its parameters' dtype (fp32), as
        the JAX package's flax convs promote a bf16 input with fp32
        parameters."""
        h = self._patch(x)
        h = h.to(self.quant_conv.conv3d.weight.dtype).permute(0, 4, 1, 2, 3)
        return self.quant_conv(self.encoder(h)).permute(0, 2, 3, 4, 1)

    def _decode_nc(self, z: torch.Tensor) -> torch.Tensor:
        h = z.to(self.post_quant_conv.conv3d.weight.dtype).permute(0, 4, 1, 2, 3)
        h = self.decoder(self.post_quant_conv(h))
        return self._unpatch(h.permute(0, 2, 3, 4, 1))

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
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


class CausalDiscreteVideoTokenizer(_VideoNetwork):
    """encoder -> quant_conv -> FSQ -> post_quant_conv -> decoder
    (reference: networks/discrete_video.py:33-145)."""

    def __init__(self, cfg: DiscreteVideoConfig = DV4x8x8_CONFIG):
        super().__init__()
        self.cfg = cfg
        # the encode half first, so that init_random_ draws its weights
        # independently of the decoder's
        self.encoder = _ENCODERS[cfg.encoder](cfg)
        self.quant_conv = CausalConv3d(cfg.z_factor * cfg.z_channels, cfg.embedding_dim,
                                       (1, 1, 1), padding=0)
        self.decoder = _DECODERS[cfg.decoder](cfg)
        self.post_quant_conv = CausalConv3d(cfg.embedding_dim, cfg.z_channels, (1, 1, 1),
                                            padding=0)
        self.quantizer = FSQ(cfg.levels)

    def encode_latent(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, H, W, 3) in [-1, 1] -> pre-FSQ latent (B, t, h, w, 6)
        (the patch in x's dtype, the network in fp32: `_encode_nc`)."""
        return self._encode_nc(x)

    def encode(self, x: torch.Tensor):
        """x: (B, T, H, W, 3) in [-1, 1] -> (indices (B, t, h, w) int32,
        codes (B, t, h, w, 6) fp32)."""
        return self.quantizer(self.encode_latent(x).float())

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes: (B, t, h, w, 6) -> video (B, 1 + (t - 1) * pt, H, W, 3) in
        about [-1, 1], in the parameters' dtype."""
        return self._decode_nc(codes)

    def decode_code(self, indices: torch.Tensor) -> torch.Tensor:
        """indices (B, t, h, w) -> video, as `decode`."""
        return self.decode(self.quantizer.indices_to_codes(indices))


@dataclasses.dataclass(frozen=True)
class ContinuousVideoConfig(DiscreteVideoConfig):
    """The CV tokenizer's config (reference: networks/configs.py:100-121)."""
    latent_channels: int = 16
    formulation: str = "AE"  # or "VAE" (z_factor 2: the encoder emits mean and logvar)
    spatial_compression: int = 8
    temporal_compression: int = 8


CV8x8x8_CONFIG = ContinuousVideoConfig()
CV4x8x8_CONFIG = ContinuousVideoConfig(temporal_compression=4)


class CausalContinuousVideoTokenizer(_VideoNetwork):
    """The AE / VAE causal video tokenizer (reference:
    networks/continuous_video.py:31-118): encoder -> quant_conv -> the
    identity (AE) or a Gaussian (VAE) -> post_quant_conv -> decoder.  As in
    the reference, at temporal compression 4 only the decoder drops to
    channels_mult (2, 4) (continuous_video.py:44-45)."""

    def __init__(self, cfg: ContinuousVideoConfig = CV8x8x8_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.encoder = _ENCODERS[cfg.encoder](cfg)
        self.quant_conv = CausalConv3d(cfg.z_factor * cfg.z_channels,
                                       cfg.z_factor * cfg.latent_channels, (1, 1, 1), padding=0)
        dec_cfg = (dataclasses.replace(cfg, channels_mult=(2, 4))
                   if cfg.temporal_compression == 4 else cfg)
        self.decoder = _DECODERS[cfg.decoder](dec_cfg)
        self.post_quant_conv = CausalConv3d(cfg.latent_channels, cfg.z_channels, (1, 1, 1),
                                            padding=0)

    def encode(self, x: torch.Tensor, generator: torch.Generator = None, noise=None):
        """x: (B, T, H, W, 3) in [-1, 1] -> (latent (B, t, h, w, C), (mean,
        logvar)).  The VAE samples with `noise` (standard normal draws) or
        from `generator`; with neither it returns the mean."""
        moments = self._encode_nc(x)
        if self.cfg.formulation == "VAE":
            return gaussian_distribution(moments, generator, noise=noise)
        return identity_distribution(moments)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latent (B, t, h, w, C) -> video (B, T, H, W, 3), in the
        parameters' dtype."""
        return self._decode_nc(z)
