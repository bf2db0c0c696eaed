"""User-facing causal video tokenizer: uint8 video in, token grids out.

Port of `CausalVideoTokenizer.forward` from
egom2p_tpu/tokenizers/cosmos/video_api.py (reference:
cosmos_tokenizer/video_lib.py:33-152): a 17-frame temporal window slides over
the video; each window is padded to the tokenizer's alignment on the device
(black spatially, edge frames in time), converted from uint8 to [-1, 1] on
the device, and encoded to FSQ indices.  Input and output are channels-last,
as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from egom2p_torch.tokenizers.cosmos.network import (CausalDiscreteVideoTokenizer,
                                                    DiscreteVideoConfig)


def pad_video_window(x: torch.Tensor, temporal_align: int,
                     spatial_align: int) -> torch.Tensor:
    """Zero-pad H and W to `spatial_align` and edge-pad time so
    (T - 1) % temporal_align == 0, split low/high like the reference
    (cosmos_tokenizer/utils.py:325-380).  x: (B, T, H, W, C)."""
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


class CausalVideoTokenizer:
    """Bundles the network with the windowed uint8 encode.

    The network is cast to `compute_dtype` (bf16 by default; float32 for
    parity tests); norms and FSQ compute in fp32 either way."""

    def __init__(self, net: CausalDiscreteVideoTokenizer,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.net = net.to(compute_dtype).eval()
        self.cfg: DiscreteVideoConfig = net.cfg
        self.compute_dtype = compute_dtype

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def encode_window(self, window_uint8: torch.Tensor) -> torch.Tensor:
        """One unpadded uint8 window (B, T, H, W, 3) on the device ->
        indices (B, t, h, w) int32."""
        x = pad_video_window(window_uint8, 2 * self.cfg.temporal_compression,
                             2 * self.cfg.spatial_compression)
        x = x.to(self.compute_dtype) / 127.5 - 1.0
        indices, _ = self.net.encode(x)
        return indices

    @torch.inference_mode()
    def forward(self, video_uint8, temporal_window: int = 17,
                device_out: bool = False):
        """Tokenize uint8 video (B, T, H, W, 3) of any length with a sliding
        temporal window (reference: video_lib.py:118-152).  `video_uint8`
        may be numpy or a torch tensor on any device.  Returns
        (B, t_total, h, w) int32: numpy, or a device tensor when
        `device_out`."""
        if video_uint8.ndim != 5:
            raise ValueError(f"video must be (B, T, H, W, 3), got {tuple(video_uint8.shape)}")
        video = torch.as_tensor(video_uint8).to(self.device)
        num_frames = video.shape[1]
        out = [self.encode_window(video[:, i * temporal_window:(i + 1) * temporal_window])
               for i in range((num_frames - 1) // temporal_window + 1)]
        tokens = out[0] if len(out) == 1 else torch.cat(out, dim=1)
        return tokens if device_out else tokens.cpu().numpy()

    __call__ = forward
