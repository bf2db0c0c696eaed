"""User-facing causal video tokenizers: uint8 video in, token grids (DV) or
latents (CV) out, and back to video.

Port of `CausalVideoTokenizer`, `ContinuousVideoTokenizer` and
`sliding_window_autoencode` from egom2p_tpu/tokenizers/cosmos/video_api.py
(reference: cosmos_tokenizer/video_lib.py:33-152, video_lib_ori.py:85-154):
a 17-frame temporal window slides over the video; for the DV tokenizer each
window is padded to the tokenizer's alignment on the device (black
spatially, edge frames in time), converted from uint8 to [-1, 1] on the
device, and encoded to FSQ indices; `decode` maps indices back to video and
`reconstruct` runs the round trip window by window.  The CV tokenizer's
`forward` reconstructs window by window (the host pads each window and
converts it to [-1, 1], then encode -> latent -> decode).  Input and output
are channels-last, as in the JAX package.

Precision follows the JAX package's default: the uint8 window becomes
`compute_dtype` (bf16), the [-1, 1] conversion and the Haar patch run in it,
and the network's weights and activations are fp32 from conv_in on; FSQ is
fp32. Decoding is fp32 throughout, but the CV tokenizer rounds its latent to
`compute_dtype` before the decoder (the JAX package's `_decode` casts it).
On a CUDA device, whether cuDNN and cuBLAS may run the fp32 products on TF32
is the tokenizer's own setting, one for the encode and one for the decode,
applied only while it computes.
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from egom2p_torch.tokenizers.cosmos.network import (CV8x8x8_CONFIG,
                                                    CausalContinuousVideoTokenizer,
                                                    CausalDiscreteVideoTokenizer,
                                                    ContinuousVideoConfig, DiscreteVideoConfig)

# Whether the card's fp32 convs and products may run on TF32: for the encode
# only where no token of the serving batch changes, for the decode only where
# no uint8 pixel moves by more than one level (chip_smoke.py measures both).
# On an H100 TF32 changed 292 of the B = 8 batch's 40960 tokens and moved
# 152643 of its 26.7M decoded uint8 values by more than a level: both exact.
ENCODE_TF32 = False
DECODE_TF32 = False


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


def pad_video_batch(batch: np.ndarray, temporal_align: int = 8,
                    spatial_align: int = 16) -> Tuple[np.ndarray, List[int]]:
    """The host-side pad of `pad_video_window`, with the crop region that
    `unpad_video_batch` undoes (reference: cosmos_tokenizer/utils.py:325-380)."""
    num_frames, height, width = batch.shape[-4:-1]
    hp = (spatial_align - height % spatial_align) % spatial_align
    wp = (spatial_align - width % spatial_align) % spatial_align
    fp = (temporal_align - (num_frames - 1) % temporal_align) % temporal_align
    crop_region = [fp >> 1, hp >> 1, wp >> 1,
                   num_frames + (fp >> 1), height + (hp >> 1), width + (wp >> 1)]
    batch = np.pad(batch, ((0, 0), (0, 0), (hp >> 1, hp - (hp >> 1)),
                           (wp >> 1, wp - (wp >> 1)), (0, 0)), mode="constant")
    batch = np.pad(batch, ((0, 0), (fp >> 1, fp - (fp >> 1)), (0, 0), (0, 0),
                           (0, 0)), mode="edge")
    return batch, crop_region


def unpad_video_batch(batch, crop_region: List[int]):
    f1, y1, x1, f2, y2, x2 = crop_region
    return batch[..., f1:f2, y1:y2, x1:x2, :]


def numpy2tensor(video: np.ndarray) -> np.ndarray:
    """uint8 [0..255] (B, T, H, W, 3) -> fp32 [-1, 1] (reference: utils.py:253-272)."""
    return (video.astype(np.float32) / 255.0) * 2.0 - 1.0


def tensor2uint8(video: torch.Tensor) -> torch.Tensor:
    """fp32 [-1, 1] -> uint8 [0..255] on the tensor's device, rounded as the
    reference's numpy form (reference: utils.py:275-288)."""
    x = (video.float() + 1.0) / 2.0
    return (x.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def tensor2numpy(video) -> np.ndarray:
    """fp32 [-1, 1] (a tensor on any device, or numpy) -> uint8 numpy."""
    return tensor2uint8(torch.as_tensor(video)).cpu().numpy()


def sliding_window_autoencode(autoencode_fn, video_uint8, temporal_window: int,
                              temporal_align: int, spatial_align: int,
                              device) -> np.ndarray:
    """Reconstruct uint8 video (B, T, H, W, 3) of any length window by
    window: each `temporal_window` slice padded on the host to the
    compression alignment, converted to fp32 [-1, 1] on `device`, run
    through `autoencode_fn` ([-1, 1] in and out) and unpadded
    (reference: video_lib_ori.py:122-154, video_lib.py:118-152).  Returns
    uint8 numpy."""
    if video_uint8.ndim != 5:
        raise ValueError(f"video must be (B, T, H, W, 3), got {tuple(video_uint8.shape)}")
    outs = []
    for i in range((video_uint8.shape[1] - 1) // temporal_window + 1):
        window = np.asarray(video_uint8[:, i * temporal_window:(i + 1) * temporal_window])
        padded, crop = pad_video_batch(window, temporal_align, spatial_align)
        recon = autoencode_fn(torch.from_numpy(numpy2tensor(padded)).to(device))
        outs.append(unpad_video_batch(tensor2numpy(recon), crop))
    return np.concatenate(outs, axis=1)


@contextlib.contextmanager
def tf32_precision(tf32: bool):
    """`tf32` for cuDNN's convs and cuBLAS's products while a tokenizer
    computes; the process's own settings after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class CausalVideoTokenizer:
    """Bundles the network (kept in fp32) with the windowed uint8 encode and
    the decode.  `compute_dtype` is the dtype of the encoder's input and
    Haar patch (bf16 by default, float32 for parity tests), as in the JAX
    package.  `encode_tf32` / `decode_tf32` (ENCODE_TF32 / DECODE_TF32)
    let the card's fp32 products run on TF32."""

    def __init__(self, net: CausalDiscreteVideoTokenizer,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.net = net.float().eval()
        self.cfg: DiscreteVideoConfig = net.cfg
        self.compute_dtype = compute_dtype
        self.encode_tf32 = ENCODE_TF32
        self.decode_tf32 = DECODE_TF32

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def encode_window(self, window_uint8: torch.Tensor) -> torch.Tensor:
        """One unpadded uint8 window (B, T, H, W, 3) on the device ->
        indices (B, t, h, w) int32."""
        x = pad_video_window(window_uint8, 2 * self.cfg.temporal_compression,
                             2 * self.cfg.spatial_compression)
        x = x.to(self.compute_dtype) / 127.5 - 1.0
        with tf32_precision(self.encode_tf32):
            indices, _ = self.net.encode(x)
        return indices

    @torch.inference_mode()
    def encode(self, video_pm1: torch.Tensor):
        """(B, T, H, W, 3) in [-1, 1] on the device, already padded ->
        (indices, codes)."""
        with tf32_precision(self.encode_tf32):
            return self.net.encode(video_pm1.to(self.compute_dtype))

    @torch.inference_mode()
    def decode(self, indices) -> torch.Tensor:
        """(B, t, h, w) token indices (numpy or a tensor on any device) ->
        fp32 video (B, 1 + (t - 1) * pt, H, W, 3) in about [-1, 1], on the
        tokenizer's device."""
        indices = torch.as_tensor(indices).to(self.device)
        with tf32_precision(self.decode_tf32):
            return self.net.decode_code(indices)

    def autoencode(self, video_pm1: torch.Tensor) -> torch.Tensor:
        """encode -> decode round trip on one padded window
        (reference: video_lib_ori.py:85-99)."""
        indices, _ = self.encode(video_pm1)
        return self.decode(indices)

    def reconstruct(self, video_uint8: np.ndarray, temporal_window: int = 17) -> np.ndarray:
        """Reconstruct uint8 video (B, T, H, W, 3) of any length through the
        autoencoder, window by window: each window padded to the
        compression alignment, round-tripped in [-1, 1] and unpadded
        (reference: video_lib_ori.py:122-154).  Returns uint8 numpy."""
        return sliding_window_autoencode(self.autoencode, video_uint8, temporal_window,
                                         2 * self.cfg.temporal_compression,
                                         2 * self.cfg.spatial_compression, self.device)

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


class ContinuousVideoTokenizer:
    """The CV (continuous latent) counterpart of CausalVideoTokenizer
    (reference: video_lib.py:84-116 handles both; the continuous branch
    returns a latent instead of indices).  The network stays fp32; the
    input is cast to `compute_dtype` (bf16 by default, float32 for parity
    tests) before the patch, and so is the latent before the decoder, as in
    the JAX package.  `encode_tf32` / `decode_tf32` let the card's fp32
    products run on TF32."""

    def __init__(self, net: CausalContinuousVideoTokenizer,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.net = net.float().eval()
        self.cfg: ContinuousVideoConfig = net.cfg
        self.compute_dtype = compute_dtype
        self.encode_tf32 = ENCODE_TF32
        self.decode_tf32 = DECODE_TF32

    @classmethod
    def random_init(cls, generator: torch.Generator, cfg: ContinuousVideoConfig = None,
                    device=None, **kw) -> "ContinuousVideoTokenizer":
        """Random weights from `generator`, on `generator`'s device unless
        `device` says otherwise (the JAX package's random_init)."""
        net = CausalContinuousVideoTokenizer(cfg or CV8x8x8_CONFIG)
        net = net.to(device if device is not None else generator.device)
        return cls(net.init_random_(generator), **kw)

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    @torch.inference_mode()
    def encode(self, video_pm1):
        """(B, T, H, W, 3) in [-1, 1], padded -> (latent (B, t, h, w, C),):
        the AE's latent, the VAE's mean."""
        x = torch.as_tensor(video_pm1).to(self.device, self.compute_dtype)
        with tf32_precision(self.encode_tf32):
            latent, _ = self.net.encode(x)
        return (latent,)

    @torch.inference_mode()
    def decode(self, latent) -> torch.Tensor:
        """latent (B, t, h, w, C) -> fp32 video in about [-1, 1]."""
        z = torch.as_tensor(latent).to(self.device).to(self.compute_dtype)
        with tf32_precision(self.decode_tf32):
            return self.net.decode(z)

    def autoencode(self, video_pm1) -> torch.Tensor:
        return self.decode(self.encode(video_pm1)[0])

    def forward(self, video_uint8, temporal_window: int = 17) -> np.ndarray:
        """uint8 (B, T, H, W, 3) -> the reconstructed uint8 video, window by
        window (reference: video_lib.py:118-152)."""
        return sliding_window_autoencode(self.autoencode, video_uint8, temporal_window,
                                         2 * self.cfg.temporal_compression,
                                         2 * self.cfg.spatial_compression, self.device)

    __call__ = forward
