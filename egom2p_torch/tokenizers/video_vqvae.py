"""ViViT-style video VQ-VAE of the rgb / depth tokenizer trainer.

Port of egom2p_tpu/tokenizers/video_vqvae.py (the architecture the
reference's `--domain rgb|depth` path intends, reference vqvae.py:80,
158-167, 427-431, 443):

  * encoder: a tubelet patchify (kernel = stride = (t, p, p), ViViT-B's
    2 x 16 x 16), the 3-D sincos posemb, ViT blocks, LayerNorm;
  * quant_proj / post_quant_proj: the 1x1 Conv3d projections as products on
    the channel-last token grid;
  * decoder: ViT blocks, LayerNorm, a product to each tubelet's pixels and
    the unpatchify;
  * the EMA codebook of ops/vq.py, as the cam / gaze tokenizers.

Channel-last throughout: clips are (B, T, H, W, C) in [-1, 1], latents
(B, t, h, w, latent_dim).  The patchify is a Conv3d weight (out, in, kt, kh,
kw) applied as one product over each tubelet's pixels, in (kt, kh, kw, C)
order.  At the CLI's video defaults (16 x 256 x 256, tubelet 2, patch 16,
dim 768, 12 heads of 64) each block attends over 2048 tokens with no mask:
models/transformer.py sends that to the flash64_train kernels (forward, dq,
dk / dv).  The network computes in fp32 (the JAX package's default); the
attention kernels round q / k / v to bf16, as JAX's do on the TPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from egom2p_torch.models.transformer import Block, LayerNorm, Linear
from egom2p_torch.ops.posemb import build_3d_sincos_posemb
from egom2p_torch.ops.vq import VQConfig
from egom2p_torch.tokenizers.seq_vqvae import Quantizer, VQAutoencoder, VQTokenizer

MLP_RATIO = 4.0


class TubeletEmbed(nn.Conv3d):
    """kernel = stride = (t, p, p) Conv3d on channel-last clips, as a
    product: (B, T, H, W, C) -> (B, T/t * H/p * W/p, dim)."""

    def __init__(self, in_channels: int, dim: int, t: int, p: int):
        super().__init__(in_channels, dim, kernel_size=(t, p, p), stride=(t, p, p))

    def forward(self, x):
        B, T, H, W, C = x.shape
        t, p = self.kernel_size[0], self.kernel_size[1]
        x = x.reshape(B, T // t, t, H // p, p, W // p, p, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = x.reshape(B, (T // t) * (H // p) * (W // p), t * p * p * C)
        weight = self.weight.permute(0, 2, 3, 4, 1).reshape(self.out_channels, -1)
        return F.linear(x, weight, self.bias)


class _VideoTrunk(nn.Module):
    def __init__(self, grid, dim: int, depth: int, num_heads: int):
        super().__init__()
        self.register_buffer("pos", torch.from_numpy(build_3d_sincos_posemb(*grid, dim)),
                             persistent=False)
        self.blocks = nn.ModuleList(Block(dim, num_heads, MLP_RATIO, qkv_bias=True)
                                    for _ in range(depth))
        self.norm = LayerNorm(dim)

    def trunk(self, x):
        x = x + self.pos.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


class VideoViTEncoder(_VideoTrunk):
    """(B, T, H, W, C) -> (B, t', h', w', dim) token grid."""

    def __init__(self, in_channels: int = 3, num_frames: int = 16, image_size: int = 256,
                 tubelet_t: int = 2, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12):
        self.grid = (num_frames // tubelet_t, image_size // patch_size, image_size // patch_size)
        super().__init__(self.grid, dim, depth, num_heads)
        self.patch_embed = TubeletEmbed(in_channels, dim, tubelet_t, patch_size)

    def forward(self, x):
        return self.trunk(self.patch_embed(x)).reshape(x.shape[0], *self.grid, -1)


class VideoViTDecoder(_VideoTrunk):
    """(B, t', h', w', dim) -> (B, T, H, W, C)."""

    def __init__(self, out_channels: int = 3, num_frames: int = 16, image_size: int = 256,
                 tubelet_t: int = 2, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12):
        grid = (num_frames // tubelet_t, image_size // patch_size, image_size // patch_size)
        super().__init__(grid, dim, depth, num_heads)
        self.out_channels, self.tubelet_t, self.patch_size = out_channels, tubelet_t, patch_size
        self.out_proj = Linear(dim, tubelet_t * patch_size * patch_size * out_channels)

    def forward(self, x):
        B, t, h, w, _ = x.shape
        x = self.out_proj(self.trunk(x.reshape(B, t * h * w, -1)))
        pt, p, c = self.tubelet_t, self.patch_size, self.out_channels
        # unpatchify: (B, t*h*w, pt*p*p*c) -> (B, T, H, W, C)
        x = x.reshape(B, t, h, w, pt, p, p, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
        return x.reshape(B, t * pt, h * p, w * p, c)


class VideoAutoencoder(VQAutoencoder):
    """Encoder + quant / post-quant projections + codebook + decoder."""

    def __init__(self, n_channels: int = 3, num_frames: int = 16, image_size: int = 256,
                 tubelet_t: int = 2, patch_size: int = 16, latent_dim: int = 32,
                 dim: int = 768, depth: int = 12, num_heads: int = 12,
                 vq_cfg: VQConfig = None):
        super().__init__()
        self.n_channels = n_channels
        self.latent_grid = (num_frames // tubelet_t, image_size // patch_size,
                            image_size // patch_size)
        kw = dict(num_frames=num_frames, image_size=image_size, tubelet_t=tubelet_t,
                  patch_size=patch_size, dim=dim, depth=depth, num_heads=num_heads)
        self.encoder = VideoViTEncoder(n_channels, **kw)
        self.decoder = VideoViTDecoder(n_channels, **kw)
        # 1x1 Conv3d == a product on channel-last grids (reference: vqvae.py:163-167)
        self.quant_proj = Linear(dim, latent_dim)
        self.post_quant_proj = Linear(latent_dim, dim)
        self.quantize = Quantizer(vq_cfg or VQConfig(dim=latent_dim))


class VideoVQTokenizer(VQTokenizer):
    """tokenize / decode_tokens / autoencode on (B, T, H, W, C) clips in
    [-1, 1]; tokens are (B, t', h', w')."""


def video_vqvae_from_config(domain: str, generator: torch.Generator = None,
                            num_frames: int = 16, image_size: int = 256, tubelet_t: int = 2,
                            patch_size: int = 16, codebook_size: int = 8192,
                            latent_dim: int = 32, ema_decay: float = 0.99,
                            threshold_ema_dead_code: float = 2.0,
                            commitment_weight: float = 1.0, kmeans_init: bool = False,
                            code_replacement_policy: str = "batch_random",
                            norm_codes: bool = True, dim: int = 768, depth: int = 12,
                            num_heads: int = 12, device=None) -> VideoVQTokenizer:
    """An rgb (3 channels) or depth (1 channel) video tokenizer on `device`:
    random weights from `generator` (on that device), or zeros to be loaded
    over when `generator` is None (egom2p_tpu/tokenizers/video_vqvae.py:
    video_vqvae_from_config's arguments; the reference's dead-code
    threshold for video is 2.0, run_training_vqvae.py:391)."""
    channels = {"rgb": 3, "depth": 1}
    if domain not in channels:
        raise ValueError(f"unknown video-vqvae domain {domain!r}")
    vq_cfg = VQConfig(codebook_size=codebook_size, dim=latent_dim, decay=ema_decay,
                      threshold_ema_dead_code=threshold_ema_dead_code,
                      commitment_weight=commitment_weight, use_cosine_sim=norm_codes,
                      kmeans_init=kmeans_init, code_replacement_policy=code_replacement_policy)
    net = VideoAutoencoder(channels[domain], num_frames, image_size, tubelet_t, patch_size,
                           latent_dim, dim, depth, num_heads, vq_cfg)
    if device is not None:
        net = net.to(device)
    if generator is not None:
        net.init_random_(generator)
    return VideoVQTokenizer(net)
