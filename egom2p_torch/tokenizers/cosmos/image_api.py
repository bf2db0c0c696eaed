"""User-facing Cosmos image tokenizer: uint8 images in, tokens (DI) or
latents (CI) out, and back to images.

Port of egom2p_tpu/tokenizers/cosmos/image_api.py (reference:
cosmos_tokenizer/image_lib.py:32-128): a batch of images is center-padded
to the tokenizer's spatial alignment, encoded, decoded and unpadded back to
uint8.  `forward` takes uint8 (B, H, W, 3); encode / decode / autoencode
take [-1, 1] tensors, channel-last.  encode returns (indices, codes) for
DI and (latent,) for CI, as the JAX package's.

Precision follows the JAX package's default: the input is cast to
`compute_dtype` (bf16) and patched in it, the network is fp32 from conv_in
on; CI rounds its latent to `compute_dtype` before the decoder.  On a CUDA
device `encode_tf32` / `decode_tf32` let the fp32 convs and products run on
TF32 (both off: exact fp32).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from egom2p_torch.tokenizers.cosmos.image_network import (CI_CONFIG, DI_CONFIG,
                                                          ContinuousImageTokenizer,
                                                          DiscreteImageTokenizer,
                                                          ImageTokenizerConfig)
from egom2p_torch.tokenizers.cosmos.video_api import numpy2tensor, tensor2numpy, tf32_precision

_SPATIAL_ALIGN = 16


def pad_image_batch(batch: np.ndarray,
                    spatial_align: int = _SPATIAL_ALIGN) -> Tuple[np.ndarray, List[int]]:
    """Center-pad (B, H, W, C) with zeros to a multiple of `spatial_align`
    (reference: utils.py:290-327).  Returns (padded, crop region)."""
    height, width = batch.shape[1:3]
    hp = (spatial_align - height % spatial_align) % spatial_align
    wp = (spatial_align - width % spatial_align) % spatial_align
    crop_region = [hp >> 1, wp >> 1, height + (hp >> 1), width + (wp >> 1)]
    batch = np.pad(batch, ((0, 0), (hp >> 1, hp - (hp >> 1)), (wp >> 1, wp - (wp >> 1)),
                           (0, 0)), mode="constant")
    return batch, crop_region


def unpad_image_batch(batch, crop_region: List[int]):
    """(reference: utils.py:397-409)."""
    y1, x1, y2, x2 = crop_region
    return batch[..., y1:y2, x1:x2, :]


class ImageTokenizer:
    """A DiscreteImageTokenizer (DI) or ContinuousImageTokenizer (CI),
    kept in fp32, with encode / decode / autoencode / forward; which class
    decides encode's return signature (reference: image_lib.py:93-111)."""

    def __init__(self, net, compute_dtype: torch.dtype = torch.bfloat16):
        self.net = net.float().eval()
        self.cfg: ImageTokenizerConfig = net.cfg
        self.discrete = isinstance(net, DiscreteImageTokenizer)
        self.compute_dtype = compute_dtype
        self.encode_tf32 = False
        self.decode_tf32 = False

    @classmethod
    def random_init(cls, generator: torch.Generator, cfg: ImageTokenizerConfig = None,
                    discrete: bool = True, device=None, **kw) -> "ImageTokenizer":
        """Random weights from `generator`, on `generator`'s device unless
        `device` says otherwise."""
        cfg = cfg or (DI_CONFIG if discrete else CI_CONFIG)
        net = (DiscreteImageTokenizer if discrete else ContinuousImageTokenizer)(cfg)
        net = net.to(device if device is not None else generator.device)
        return cls(net.init_random_(generator), **kw)

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    @torch.inference_mode()
    def encode(self, input_tensor):
        """(B, H, W, 3) in [-1, 1], padded -> DI: (indices, codes); CI:
        (latent,)."""
        x = torch.as_tensor(input_tensor).to(self.device, self.compute_dtype)
        with tf32_precision(self.encode_tf32):
            out = self.net.encode(x)
        return out[:2] if self.discrete else (out[0],)

    @torch.inference_mode()
    def decode(self, input_latent) -> torch.Tensor:
        """DI: indices (B, h, w) -> image; CI: latent (B, h, w, C) -> image;
        fp32 in about [-1, 1]."""
        z = torch.as_tensor(input_latent).to(self.device)
        with tf32_precision(self.decode_tf32):
            if self.discrete:
                return self.net.decode_code(z)
            return self.net.decode(z.to(self.compute_dtype))

    def autoencode(self, input_tensor) -> torch.Tensor:
        return self.decode(self.encode(input_tensor)[0])

    def forward(self, image: np.ndarray) -> np.ndarray:
        """uint8 (B, H, W, 3) -> the reconstructed uint8 images, same shape
        (reference: image_lib.py:113-128)."""
        padded, crop_region = pad_image_batch(image, spatial_align=self.cfg.spatial_compression)
        recon = self.autoencode(torch.from_numpy(numpy2tensor(padded)).to(self.device))
        return unpad_image_batch(tensor2numpy(recon), crop_region)
