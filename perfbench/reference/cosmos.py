"""Plain PyTorch reference of the Cosmos DV4x8x8 video tokenizer: encoder,
FSQ and decoder, FACTORIZED network, NCTHW inside, channels-last outside.

A frozen copy of the port's egom2p_torch/tokenizers/cosmos/{layers,network}.py
and ops/{fsq,wavelet}.py as they stood when the benchmark was written
(reference: cosmos_tokenizer/modules/layers3d.py, quantizers.py,
patching.py), cut to the FACTORIZED DV path, so that a later change to the
port cannot move the yardstick.  Parameter names follow the reference torch
keys, the port's names, so one seeded weight set fills both.  It imports
nothing of the port.

Precision is the configuration's: the uint8 clip becomes bf16, the [-1, 1]
conversion and the Haar patch run in bf16, the network and FSQ run in fp32;
the caller decides whether the fp32 products may use TF32 (`tf32`), off for
the reference and on for its control.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
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


class CausalHybridUpsample3d(nn.Module):
    """Temporal repeat + causal conv and/or nearest 2x spatial upsample +
    conv, each with a residual add, then a 1x1x1 conv
    (reference: layers3d.py:144-200)."""

    def __init__(self, channels: int, spatial_up: bool = True, temporal_up: bool = True):
        super().__init__()
        self.spatial_up = spatial_up
        self.temporal_up = temporal_up
        if temporal_up:
            self.conv1 = CausalConv3d(channels, channels, (3, 1, 1), padding=0)
        if spatial_up:
            self.conv2 = CausalConv3d(channels, channels, (1, 3, 3), padding=1)
        if spatial_up or temporal_up:
            self.conv3 = CausalConv3d(channels, channels, (1, 1, 1), padding=0)

    def forward(self, x):
        if not self.spatial_up and not self.temporal_up:
            return x
        if self.temporal_up:
            # each frame twice, the first copy of frame 0 dropped: T -> 2T - 1
            time_factor = 2 if x.shape[2] > 1 else 1
            x = x.repeat_interleave(time_factor, dim=2)[:, :, time_factor - 1:]
            x = self.conv1(x) + x
        if self.spatial_up:
            x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
            x = self.conv2(x) + x
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


class FSQ:
    def __init__(self, levels: Sequence[int] = (8, 8, 8, 5, 5, 5)):
        self.levels = np.asarray(levels, dtype=np.int32)
        self.dim = len(levels)
        # mixed-radix basis (reference: quantizers.py:96-99)
        self.basis = np.concatenate([[1], np.cumprod(self.levels[:-1])]).astype(np.int32)
        self.codebook_size = int(np.prod(self.levels))

    def _const(self, arr, z: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.float32), device=z.device)

    def bound(self, z: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
        """(reference: quantizers.py:136-141)"""
        levels = self._const(self.levels, z)
        half_l = (levels - 1) * (1 + eps) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        shift = torch.atanh(offset / half_l)
        return torch.tanh(z + shift) * half_l - offset

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """z: (..., dim) -> normalized codes in [-1, 1]
        (reference: quantizers.py:143-147)."""
        bounded = self.bound(z.float())
        # the straight-through form of the JAX package, bounded + sg(rounded -
        # bounded), which equals `rounded` exactly in fp32
        quantized = bounded + (torch.round(bounded) - bounded).detach()
        return quantized / self._const(self.levels // 2, z)

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        """normalized codes (..., dim) -> int32 indices (...)."""
        half_width = self._const(self.levels // 2, zhat)
        shifted = zhat * half_width + half_width  # in [0, levels - 1]
        return (shifted * self._const(self.basis, zhat)).sum(dim=-1).to(torch.int32)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """int indices (...) -> normalized codes (..., dim), fp32."""
        idx = indices.to(torch.int64)[..., None]
        basis = torch.as_tensor(self.basis.astype(np.int64), device=indices.device)
        levels = torch.as_tensor(self.levels.astype(np.int64), device=indices.device)
        half_width = self._const(self.levels // 2, indices)
        return (torch.div(idx, basis, rounding_mode="floor") % levels - half_width) / half_width

    def __call__(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z: (..., dim) -> (indices (...), codes (..., dim))."""
        codes = self.quantize(z)
        return self.codes_to_indices(codes), codes



def _axis_dwt(x: torch.Tensor, axis: int):
    n = x.shape[axis]
    if n % 2:
        raise ValueError(f"axis {axis} length {n} must be even for the Haar DWT")
    xr = x.unflatten(axis, (n // 2, 2))
    x0, x1 = xr.select(axis + 1, 0), xr.select(axis + 1, 1)
    return (x0 + x1) * 0.5, (x0 - x1) * 0.5


def _axis_idwt(lo: torch.Tensor, hi: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.stack([lo + hi, lo - hi], dim=axis + 1).flatten(axis, axis + 1)


def dwt3d(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T/2, H/2, W/2, 8*C), subband-major channels."""
    lt, ht = _axis_dwt(x, 1)
    bands = []
    for tb in (lt, ht):
        lh, hh = _axis_dwt(tb, 2)
        for hb in (lh, hh):
            bands.extend(_axis_dwt(hb, 3))
    return torch.cat(bands, dim=-1)


def patch3d_haar(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Causal 3D Haar patching: the first frame is repeated `patch_size`
    times so a 1+(T-1) causal clip maps to (T-1+patch)/patch latent frames
    (reference: patching.py:161-166)."""
    x = torch.cat([x[:, :1].expand(-1, patch_size, -1, -1, -1), x[:, 1:]], dim=1)
    for _ in range(int(patch_size).bit_length() - 1):
        x = dwt3d(x)
    return x


def idwt3d(x: torch.Tensor) -> torch.Tensor:
    """Inverse of dwt3d: (B, T, H, W, 8*C) -> (B, 2T, 2H, 2W, C)."""
    bands = x.chunk(8, dim=-1)
    t_parts = []
    for tb in range(2):
        h_parts = [_axis_idwt(bands[tb * 4 + hb * 2], bands[tb * 4 + hb * 2 + 1], 3)
                   for hb in range(2)]
        t_parts.append(_axis_idwt(h_parts[0], h_parts[1], 2))
    return _axis_idwt(t_parts[0], t_parts[1], 1)


def unpatch3d_haar(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Inverse patching; drops the (patch_size - 1) repeated lead frames
    (reference: patching.py:341-345)."""
    for _ in range(int(patch_size).bit_length() - 1):
        x = idwt3d(x)
    return x[:, patch_size - 1:]


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




@contextlib.contextmanager
def tf32(on: bool):
    """Whether cuDNN's convs and cuBLAS's products may run fp32 on TF32."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def pad_window(x: torch.Tensor, temporal_align: int, spatial_align: int) -> torch.Tensor:
    """Zero-pad H and W to `spatial_align`, edge-pad time so that
    (T - 1) % temporal_align == 0 (reference: cosmos_tokenizer/utils.py:325-380)."""
    T, H, W = x.shape[1:4]
    hp = (spatial_align - H % spatial_align) % spatial_align
    wp = (spatial_align - W % spatial_align) % spatial_align
    fp = (temporal_align - (T - 1) % temporal_align) % temporal_align
    if hp or wp:
        x = F.pad(x, (0, 0, wp >> 1, wp - (wp >> 1), hp >> 1, hp - (hp >> 1)))
    if fp:
        before, after = fp >> 1, fp - (fp >> 1)
        x = torch.cat([x[:, :1].expand(-1, before, -1, -1, -1), x,
                       x[:, -1:].expand(-1, after, -1, -1, -1)], dim=1)
    return x


def to_uint8(video: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8, rounded as the reference's numpy form (utils.py:275-288)."""
    x = (video.float() + 1.0) / 2.0
    return (x.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


class DiscreteVideoTokenizer(nn.Module):
    """encoder -> quant_conv -> FSQ, and FSQ codes -> post_quant_conv ->
    decoder (reference: networks/discrete_video.py:33-145)."""

    def __init__(self, cfg: DiscreteVideoConfig = DiscreteVideoConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = EncoderFactorized(cfg)
        self.quant_conv = CausalConv3d(cfg.z_factor * cfg.z_channels, cfg.embedding_dim,
                                       (1, 1, 1), padding=0)
        self.decoder = DecoderFactorized(cfg)
        self.post_quant_conv = CausalConv3d(cfg.embedding_dim, cfg.z_channels, (1, 1, 1),
                                            padding=0)
        self.quantizer = FSQ(cfg.levels)

    @torch.no_grad()
    def tokenize(self, clips_uint8: torch.Tensor) -> torch.Tensor:
        """uint8 clips (B, T, H, W, 3) of one temporal window -> FSQ indices
        (B, t, h, w) int32."""
        cfg = self.cfg
        x = pad_window(clips_uint8, 2 * cfg.temporal_compression, 2 * cfg.spatial_compression)
        x = x.to(torch.bfloat16) / 127.5 - 1.0
        h = patch3d_haar(x, cfg.patch_size).float().permute(0, 4, 1, 2, 3)
        z = self.quant_conv(self.encoder(h)).permute(0, 2, 3, 4, 1)
        indices, _ = self.quantizer(z.float())
        return indices

    @torch.no_grad()
    def decode(self, indices: torch.Tensor, frames: int, gray: bool) -> torch.Tensor:
        """indices (B, t, h, w) -> uint8 video (B, frames, H, W, 3); `gray`
        takes the floor of the channels' mean (a depth target)."""
        codes = self.quantizer.indices_to_codes(indices)
        h = self.post_quant_conv(codes.float().permute(0, 4, 1, 2, 3))
        video = unpatch3d_haar(self.decoder(h).permute(0, 2, 3, 4, 1), self.cfg.patch_size)
        video = to_uint8(video)[:, :frames]
        if gray:
            mean = torch.div(video.sum(dim=-1, keepdim=True, dtype=torch.int32), 3,
                             rounding_mode="floor")
            video = mean.to(torch.uint8).expand(*video.shape)
        return video


def config_of(tok: dict) -> DiscreteVideoConfig:
    """The DV config a configuration file's `tokenizer` section states."""
    return DiscreteVideoConfig(
        channels=tok["channels"], channels_mult=tuple(tok["channels_mult"]),
        num_res_blocks=tok["num_res_blocks"], z_channels=tok["z_channels"],
        patch_size=tok["patch_size"], spatial_compression=tok["spatial_compression"],
        temporal_compression=tok["temporal_compression"], levels=tuple(tok["levels"]))
