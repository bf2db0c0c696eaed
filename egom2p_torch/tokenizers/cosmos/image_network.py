"""Cosmos image tokenizers: discrete (DI) and continuous (CI).

Port of egom2p_tpu/tokenizers/cosmos/image_network.py (reference:
cosmos_tokenizer/networks/discrete_image.py:28-129, continuous_image.py:
32-104, configs.py:26-98) on the 2-D encoder and decoder of layers2d.py.
The default configs are the reference's CI / DI: spatial compression 16, a
Haar patch of 4, channels 128 x (2, 4, 4).  The DI quantizer is FSQ,
residual FSQ (RESFSQ), lookup-free (LFQ: quant_conv emits `codebook_dim`
channels, one bit each) or the taming VQ (ops/quantizers.py, its codebook
`quantizer.embedding.weight`).  Public functions take and return the JAX
package's channel-last layout; the networks compute in their parameters'
dtype (fp32).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from egom2p_torch.ops.fsq import FSQ, LFQ, ResidualFSQ
from egom2p_torch.ops.quantizers import TamingVectorQuantizer
from egom2p_torch.tokenizers.cosmos.distributions import (gaussian_distribution,
                                                          identity_distribution)
from egom2p_torch.tokenizers.cosmos.layers2d import Decoder2d, Encoder2d, Normalize2d, _conv2d


@dataclasses.dataclass(frozen=True)
class ImageTokenizerConfig:
    """(reference: networks/configs.py:26-98)."""
    attn_resolutions: Tuple[int, ...] = (32,)
    channels: int = 128
    channels_mult: Tuple[int, ...] = (2, 4, 4)
    in_channels: int = 3
    spatial_compression: int = 16
    num_res_blocks: int = 2
    out_channels: int = 3
    resolution: int = 1024
    patch_size: int = 4
    patch_method: str = "haar"
    # continuous (CI)
    latent_channels: int = 16
    z_channels: int = 16
    z_factor: int = 1
    formulation: str = "AE"  # or "VAE"
    # discrete (DI)
    quantizer: str = "FSQ"   # VQ | LFQ | FSQ | RESFSQ
    embedding_dim: int = 6
    levels: Tuple[int, ...] = (8, 8, 8, 5, 5, 5)
    num_quantizers: int = 4
    num_embeddings: Optional[int] = None  # for VQ
    codebook_dim: int = 16                # for LFQ


CI_CONFIG = ImageTokenizerConfig()
DI_CONFIG = ImageTokenizerConfig(z_channels=256)
# the public f8 variants
CI8x8_CONFIG = ImageTokenizerConfig(spatial_compression=8)
DI8x8_CONFIG = ImageTokenizerConfig(z_channels=256, spatial_compression=8)


class _ImageNetwork(nn.Module):
    """The encoder / decoder pair with its 1x1 projections, and the random
    init both tokenizers share."""

    def __init__(self, cfg: ImageTokenizerConfig, quant_out: int, latent: int):
        """quant_conv: the encoder's z_factor x z_channels -> `quant_out`;
        post_quant_conv: the `latent` channels the decoder takes -> z_channels."""
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder2d(cfg)
        self.decoder = Decoder2d(cfg)
        self.quant_conv = _conv2d(cfg.z_factor * cfg.z_channels, quant_out, 1, padding=0)
        self.post_quant_conv = _conv2d(latent, cfg.z_channels, 1, padding=0)

    def _encode_nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] -> quant_conv's output (B, h, w, C)."""
        return self.quant_conv(self.encoder(x)).permute(0, 2, 3, 1)

    def _decode_nhwc(self, z: torch.Tensor) -> torch.Tensor:
        """(B, h, w, C) -> (B, H, W, 3), in the parameters' dtype."""
        z = z.to(self.post_quant_conv.weight.dtype).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z))

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Random weights from `generator` (on the module's device), as
        flax's defaults: lecun-normal convs (std fan_in^-0.5), zero biases,
        unit GroupNorm scales; a taming codebook uniform in [-1/n, 1/n)."""
        for m in self.modules():
            if isinstance(m, Normalize2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
                m.bias.zero_()
            elif isinstance(m, TamingVectorQuantizer):
                m.init_random_(generator)
        return self


class DiscreteImageTokenizer(_ImageNetwork):
    """encoder -> quant_conv -> quantizer -> post_quant_conv -> decoder
    (reference: networks/discrete_image.py:28-129)."""

    def __init__(self, cfg: ImageTokenizerConfig = DI_CONFIG):
        q = cfg.quantizer
        # LFQ takes codebook_dim channels (a bit each); the others embedding_dim
        quant_ch = cfg.codebook_dim if q == "LFQ" else cfg.embedding_dim
        super().__init__(cfg, quant_ch, quant_ch)
        if q == "FSQ":
            self.quantizer = FSQ(cfg.levels)
        elif q == "RESFSQ":
            self.quantizer = ResidualFSQ(cfg.levels, cfg.num_quantizers)
        elif q == "LFQ":
            self.quantizer = LFQ(cfg.codebook_dim)
        elif q == "VQ":
            if not cfg.num_embeddings:
                raise ValueError("the VQ quantizer needs `num_embeddings`")
            self.quantizer = TamingVectorQuantizer(cfg.num_embeddings, cfg.embedding_dim,
                                                   beta=0.25)
        else:
            raise ValueError(f"unknown quantizer {q!r}")

    def encode(self, x: torch.Tensor):
        """x: (B, H, W, 3) in [-1, 1] -> (indices, codes (B, h, w, C),
        quantizer loss): indices (B, h, w), or (B, num_quantizers, h, w)
        for RESFSQ."""
        h = self._encode_nhwc(x)
        if self.cfg.quantizer == "VQ":
            b, gh, gw, c = h.shape
            z_q, loss, (indices, *_) = self.quantizer(h.reshape(b, gh * gw, c).float())
            return indices.reshape(b, gh, gw), z_q.reshape(b, gh, gw, c), loss
        indices, codes = self.quantizer(h.float())
        return indices, codes, torch.zeros((), device=h.device)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, h, w, C) -> image (B, H, W, 3)."""
        return self._decode_nhwc(codes)

    def decode_code(self, indices: torch.Tensor) -> torch.Tensor:
        if self.cfg.quantizer == "VQ":
            return self.decode(self.quantizer.get_codebook_entry(indices))
        return self.decode(self.quantizer.indices_to_codes(indices))


class ContinuousImageTokenizer(_ImageNetwork):
    """The AE / VAE image tokenizer (reference: networks/continuous_image.py:
    32-104); a VAE's encoder emits mean and logvar (z_factor 2)."""

    def __init__(self, cfg: ImageTokenizerConfig = CI_CONFIG):
        super().__init__(cfg, cfg.z_factor * cfg.latent_channels, cfg.latent_channels)

    def encode(self, x: torch.Tensor, generator: torch.Generator = None, noise=None):
        """x: (B, H, W, 3) in [-1, 1] -> (latent (B, h, w, C), (mean,
        logvar)); the VAE samples with `noise` or from `generator`, else
        returns the mean."""
        moments = self._encode_nhwc(x)
        if self.cfg.formulation == "VAE":
            return gaussian_distribution(moments, generator, noise=noise)
        return identity_distribution(moments)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self._decode_nhwc(z)
