"""Causal 3D CNN layers of the Cosmos video tokenizer's encoder.

Port of the encoder layers of egom2p_tpu/tokenizers/cosmos/layers.py
(reference: cosmos_tokenizer/modules/layers3d.py): causal convs with
first-frame replicate padding in time, per-frame GroupNorm, the hybrid
spatial/temporal downsample, factorized resnet blocks, and spatial and causal
temporal attention.  Tensors are NCTHW (B, C, T, H, W) inside, for
torch.nn.functional.conv3d; the network's public functions take and return
the JAX package's channels-last layout.  Module names follow the reference
torch keys (`conv3d`, `norm.norm`, `conv1.0`, ...).

The attention blocks are plain dense attention in fp32: the JAX package
computes them with einsums outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def nonlinearity(x):
    return x * torch.sigmoid(x)


class CausalConv3d(nn.Module):
    """Conv3d with causal (left-replicated) temporal padding and symmetric
    zero spatial padding `padding` (reference: layers3d.py:54-101)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3), stride: int = 1,
                 time_stride: int = 1, dilation: int = 1, time_dilation: int = 1,
                 padding: int = 1):
        super().__init__()
        kt = kernel_size[0]
        self.time_pad = time_dilation * (kt - 1) + (1 - time_stride)
        self.padding = padding
        self.conv3d = nn.Conv3d(in_channels, out_channels, kernel_size,
                                stride=(time_stride, stride, stride),
                                dilation=(time_dilation, dilation, dilation))

    def forward(self, x):
        if self.time_pad > 0:
            first = x[:, :, :1].expand(-1, -1, self.time_pad, -1, -1)
            x = torch.cat([first, x], dim=2)
        if self.padding > 0:
            p = self.padding
            x = F.pad(x, (p, p, p, p, 0, 0))
        return self.conv3d(x)


class CausalNormalize(nn.Module):
    """GroupNorm computed in fp32; num_groups=1 normalizes each frame over
    (C, H, W) so causality holds (reference: modules/utils.py:67-84)."""

    def __init__(self, channels: int, num_groups: int = 1):
        super().__init__()
        self.num_groups = num_groups
        self.norm = nn.GroupNorm(num_groups, channels, eps=1e-6)

    def forward(self, x):
        xf = x.float()
        if self.num_groups == 1:
            dims = (1, 3, 4)  # per (b, t)
        else:
            xf = xf.unflatten(1, (self.num_groups, -1))
            dims = (2, 3, 4, 5)  # per (b, group), over time too
        mean = xf.mean(dim=dims, keepdim=True)
        var = (xf - mean).square().mean(dim=dims, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + 1e-6)).reshape(x.shape)
        shape = (1, -1, 1, 1, 1)
        y = y * self.norm.weight.view(shape) + self.norm.bias.view(shape)
        return y.to(x.dtype)


class CausalHybridDownsample3d(nn.Module):
    """Strided conv + average-pool residual, spatial and/or temporal
    (reference: layers3d.py:203-260)."""

    def __init__(self, channels: int, spatial_down: bool = True,
                 temporal_down: bool = True):
        super().__init__()
        self.spatial_down = spatial_down
        self.temporal_down = temporal_down
        if spatial_down:
            self.conv1 = CausalConv3d(channels, channels, (1, 3, 3), stride=2,
                                      time_stride=1, padding=0)
        if temporal_down:
            self.conv2 = CausalConv3d(channels, channels, (3, 1, 1), stride=1,
                                      time_stride=2, padding=0)
        if spatial_down or temporal_down:
            self.conv3 = CausalConv3d(channels, channels, (1, 1, 1), padding=0)

    def forward(self, x):
        if not self.spatial_down and not self.temporal_down:
            return x
        if self.spatial_down:
            xp = F.pad(x, (0, 1, 0, 1, 0, 0))
            x = self.conv1(xp) + F.avg_pool3d(xp, (1, 2, 2), (1, 2, 2))
        if self.temporal_down:
            xp = torch.cat([x[:, :, :1], x], dim=2)  # replication pad
            x = self.conv2(xp) + F.avg_pool3d(xp, (2, 1, 1), (2, 1, 1))
        return self.conv3(x)


def _factorized_conv(in_channels: int, out_channels: int) -> nn.Sequential:
    """(1,3,3) spatial conv then (3,1,1) causal temporal conv."""
    return nn.Sequential(
        CausalConv3d(in_channels, out_channels, (1, 3, 3), padding=1),
        CausalConv3d(out_channels, out_channels, (3, 1, 1), padding=0))


class CausalResnetBlockFactorized3d(nn.Module):
    """(reference: layers3d.py:306-372); inference only, so no dropout."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int = 1):
        super().__init__()
        self.norm1 = CausalNormalize(in_channels, 1)
        self.conv1 = _factorized_conv(in_channels, out_channels)
        self.norm2 = CausalNormalize(out_channels, num_groups)
        self.conv2 = _factorized_conv(out_channels, out_channels)
        self.nin_shortcut = (CausalConv3d(in_channels, out_channels, (1, 1, 1), padding=0)
                             if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(nonlinearity(self.norm1(x)))
        h = self.conv2(nonlinearity(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class _AttnBase(nn.Module):
    def __init__(self, channels: int, num_groups: int = 1):
        super().__init__()
        self.norm = CausalNormalize(channels, num_groups)
        self.q = CausalConv3d(channels, channels, (1, 1, 1), padding=0)
        self.k = CausalConv3d(channels, channels, (1, 1, 1), padding=0)
        self.v = CausalConv3d(channels, channels, (1, 1, 1), padding=0)
        self.proj_out = CausalConv3d(channels, channels, (1, 1, 1), padding=0)

    @staticmethod
    def _attend(q, k, v, blocked=None):
        """(b, n, c) dense attention, fp32 scores and softmax."""
        attn = torch.matmul(q.float(), k.float().transpose(1, 2)) * (q.shape[-1] ** -0.5)
        if blocked is not None:
            attn = attn.masked_fill(blocked, -1e30)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        return torch.matmul(attn, v)


class CausalAttnBlock(_AttnBase):
    """Spatial self-attention within each frame (reference: layers3d.py:375-421)."""

    def forward(self, x):
        h = self.norm(x)
        q, k, v = self.q(h), self.k(h), self.v(h)
        b, c, t, hh, ww = q.shape

        def fold(a):  # (b, c, t, h, w) -> (b*t, h*w, c)
            return a.permute(0, 2, 3, 4, 1).reshape(b * t, hh * ww, c)

        o = self._attend(fold(q), fold(k), fold(v))
        o = o.reshape(b, t, hh, ww, c).permute(0, 4, 1, 2, 3)
        return x + self.proj_out(o)


class CausalTemporalAttnBlock(_AttnBase):
    """Causal self-attention over time at each pixel
    (reference: layers3d.py:424-473)."""

    def forward(self, x):
        h = self.norm(x)
        q, k, v = self.q(h), self.k(h), self.v(h)
        b, c, t, hh, ww = q.shape

        def fold(a):  # (b, c, t, h, w) -> (b*h*w, t, c)
            return a.permute(0, 3, 4, 2, 1).reshape(b * hh * ww, t, c)

        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).triu(1)
        o = self._attend(fold(q), fold(k), fold(v), causal[None])
        o = o.reshape(b, hh, ww, t, c).permute(0, 4, 3, 1, 2)
        return x + self.proj_out(o)
