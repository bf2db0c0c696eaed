"""2-D layers of the Cosmos image tokenizers (CI / DI).

Port of egom2p_tpu/tokenizers/cosmos/layers2d.py (reference:
cosmos_tokenizer/modules/layers2d.py:39-368): the stable-diffusion-style 2-D
encoder and decoder.  Tensors are NCHW inside, for torch's Conv2d; Encoder2d
takes and Decoder2d returns the JAX package's channels-last layout around
the patcher.  Module names follow the reference torch keys
(`encoder.down.0.block.0.norm1.weight`, `encoder.mid.attn_1.q.weight`,
`decoder.up.1.upsample.conv.weight`): the GroupNorm is the module itself,
as the JAX converter's key map drops flax's inner `norm` scope.

The attention is plain dense attention with fp32 scores: the JAX package
computes it with einsums outside any Pallas kernel.  Which levels attend
depends on `cfg.resolution`, not on the input's size, as in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from egom2p_torch.ops.wavelet import (patch2d_haar, patch2d_rearrange, unpatch2d_haar,
                                      unpatch2d_rearrange)
from egom2p_torch.tokenizers.cosmos.layers import nonlinearity


class Normalize2d(nn.GroupNorm):
    """GroupNorm(32, eps 1e-6) in fp32, with flax's statistics: the variance
    as E[x^2] - E[x]^2 clipped at 0, and (x - mean) * (rsqrt(var + eps) *
    scale) + bias (reference: modules/utils.py:61-64)."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__(num_groups, channels, eps=1e-6)

    def forward(self, x):
        xg = x.float().unflatten(1, (self.num_groups, -1))  # (B, G, C / G, ...)
        dims = tuple(range(2, xg.dim()))
        mean = xg.mean(dim=dims, keepdim=True)
        var = torch.clamp(xg.square().mean(dim=dims, keepdim=True) - mean.square(), min=0.0)
        shape = (1, self.num_groups, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(shape)
        y = (xg - mean) * mul + self.bias.view(shape)
        return y.flatten(1, 2).to(x.dtype)


def _conv2d(in_channels: int, out_channels: int, kernel: int = 3, stride: int = 1,
            padding: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_channels, out_channels, kernel, stride=stride, padding=padding)


class Upsample2d(nn.Module):
    """Nearest 2x upsample + 3x3 conv (reference: layers2d.py:39-48)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv2d(channels, channels)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


class Downsample2d(nn.Module):
    """Right / bottom zero pad + stride-2 3x3 conv (reference:
    layers2d.py:52-62)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv2d(channels, channels, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class ResnetBlock2d(nn.Module):
    """(reference: layers2d.py:65-106); inference only, so no dropout."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = Normalize2d(in_channels)
        self.conv1 = _conv2d(in_channels, out_channels)
        self.norm2 = Normalize2d(out_channels)
        self.conv2 = _conv2d(out_channels, out_channels)
        self.nin_shortcut = (_conv2d(in_channels, out_channels, 1, padding=0)
                             if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(nonlinearity(self.norm1(x)))
        h = self.conv2(nonlinearity(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock2d(nn.Module):
    """Single-head full spatial attention over h*w positions, fp32 scores
    (reference: layers2d.py:109-147)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = Normalize2d(channels)
        self.q = _conv2d(channels, channels, 1, padding=0)
        self.k = _conv2d(channels, channels, 1, padding=0)
        self.v = _conv2d(channels, channels, 1, padding=0)
        self.proj_out = _conv2d(channels, channels, 1, padding=0)

    def forward(self, x):
        b, c, h, w = x.shape
        hid = self.norm(x)

        def fold(a):  # (b, c, h, w) -> (b, h*w, c)
            return a.flatten(2).transpose(1, 2)

        q, k, v = fold(self.q(hid)), fold(self.k(hid)), fold(self.v(hid))
        attn = torch.matmul(q.float(), k.float().transpose(1, 2))
        attn = torch.softmax(attn * (c ** -0.5), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


def _patch2d(x: torch.Tensor, patch_size: int, method: str) -> torch.Tensor:
    """(B, H, W, C) through the shared 5-D (B, T, H, W, C) patchers."""
    if patch_size == 1:
        return x
    fn = patch2d_haar if method == "haar" else patch2d_rearrange
    return fn(x[:, None], patch_size)[:, 0]


def _unpatch2d(x: torch.Tensor, patch_size: int, method: str) -> torch.Tensor:
    if patch_size == 1:
        return x
    fn = unpatch2d_haar if method == "haar" else unpatch2d_rearrange
    return fn(x[:, None], patch_size)[:, 0]


class Encoder2d(nn.Module):
    """The 2-D encoder (reference: layers2d.py:150-255).  `cfg` is an
    ImageTokenizerConfig (image_network.py).  forward: (B, H, W, 3)
    channel-last, patched here in the input's dtype, -> (B, z, h, w) NCHW in
    the parameters' dtype."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        n_levels = len(cfg.channels_mult)
        num_downsamples = int(math.log2(cfg.spatial_compression)) - int(math.log2(cfg.patch_size))
        if num_downsamples > n_levels:
            raise ValueError(f"can only downsample {n_levels} times")
        self.conv_in = _conv2d(cfg.in_channels * cfg.patch_size ** 2, cfg.channels)
        curr_res = cfg.resolution // cfg.patch_size
        block_in = cfg.channels
        self.down = nn.ModuleList()
        for i_level in range(n_levels):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_out = cfg.channels * cfg.channels_mult[i_level]
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock2d(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock2d(block_in))
            if i_level < num_downsamples:
                level.downsample = Downsample2d(block_in)
                curr_res //= 2
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock2d(block_in, block_in)
        self.mid.attn_1 = AttnBlock2d(block_in)
        self.mid.block_2 = ResnetBlock2d(block_in, block_in)
        self.norm_out = Normalize2d(block_in)
        self.conv_out = _conv2d(block_in, cfg.z_factor * cfg.z_channels)

    def forward(self, x):
        x = _patch2d(x, self.cfg.patch_size, self.cfg.patch_method)
        h = self.conv_in(x.to(self.conv_in.weight.dtype).permute(0, 3, 1, 2))
        for level in self.down:
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn) > 0:
                    h = level.attn[i_block](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(nonlinearity(self.norm_out(h)))


class Decoder2d(nn.Module):
    """The 2-D decoder (reference: layers2d.py:258-368).  forward: (B, z, h,
    w) NCHW -> (B, H, W, 3) channel-last, unpatched.  `up[i]` is level i,
    run from the last level down."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        n_levels = len(cfg.channels_mult)
        num_upsamples = int(math.log2(cfg.spatial_compression)) - int(math.log2(cfg.patch_size))
        if num_upsamples > n_levels:
            raise ValueError(f"can only upsample {n_levels} times")
        block_in = cfg.channels * cfg.channels_mult[-1]
        curr_res = (cfg.resolution // cfg.patch_size) // 2 ** (n_levels - 1)
        self.conv_in = _conv2d(cfg.z_channels, block_in)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock2d(block_in, block_in)
        self.mid.attn_1 = AttnBlock2d(block_in)
        self.mid.block_2 = ResnetBlock2d(block_in, block_in)
        levels = [None] * n_levels
        for i_level in reversed(range(n_levels)):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_out = cfg.channels * cfg.channels_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock2d(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock2d(block_in))
            if i_level >= n_levels - num_upsamples:
                level.upsample = Upsample2d(block_in)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = Normalize2d(block_in)
        self.conv_out = _conv2d(block_in, cfg.out_channels * cfg.patch_size ** 2)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn) > 0:
                    h = level.attn[i_block](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = self.conv_out(nonlinearity(self.norm_out(h)))
        return _unpatch2d(h.permute(0, 2, 3, 1), self.cfg.patch_size, self.cfg.patch_method)
