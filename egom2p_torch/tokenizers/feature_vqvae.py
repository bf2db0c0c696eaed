"""Feature-map VQ-VAE of the teacher-feature tokenizer trainer.

Port of egom2p_tpu/tokenizers/feature_vqvae.py (reference FEAT_MODALITIES,
run_training_vqvae.py:78, 400-402, 949-1002): the VQ-VAE over a frozen
teacher's patch-token grid (CLIP / DINOv2 / ImageBind, models/teachers.py)
or its cls vector as a (1, 1) grid for the `-global` domains:

  * encoder: a per-cell linear `in_proj` (the grid is already token-shaped),
    the 2-D sincos posemb (none on a 1 x 1 grid), ViT blocks, LayerNorm, a
    linear `out_proj`;
  * quant / post-quant projections and the EMA codebook of ops/vq.py;
  * decoder: the same body back to the teacher's width.

Channel-last: feature maps (B, h, w, feat_dim), latents (B, h, w,
latent_dim), tokens (B, h, w).  fp32, as the JAX package's default.
"""
from __future__ import annotations

import torch
from torch import nn

from egom2p_torch.models.transformer import Block, LayerNorm, Linear
from egom2p_torch.ops.posemb import build_2d_sincos_posemb
from egom2p_torch.ops.vq import VQConfig
from egom2p_torch.tokenizers.seq_vqvae import Quantizer, VQAutoencoder, VQTokenizer

MLP_RATIO = 4.0


class FeatureViT(nn.Module):
    """(B, h, w, in_dim) -> (B, h, w, out_dim) over a fixed (h, w) grid."""

    def __init__(self, in_dim: int, out_dim: int, grid: int, dim: int = 768, depth: int = 12,
                 num_heads: int = 12):
        super().__init__()
        self.out_dim = out_dim
        self.in_proj = Linear(in_dim, dim)
        # a 1 x 1 (global) grid needs no positional signal
        self.register_buffer("pos", torch.from_numpy(build_2d_sincos_posemb(grid, grid, dim))
                             if grid > 1 else None, persistent=False)
        self.blocks = nn.ModuleList(Block(dim, num_heads, MLP_RATIO, qkv_bias=True)
                                    for _ in range(depth))
        self.norm = LayerNorm(dim)
        self.out_proj = Linear(dim, out_dim)

    def forward(self, x):
        B, h, w, _ = x.shape
        x = self.in_proj(x).reshape(B, h * w, -1)
        if self.pos is not None:
            x = x + self.pos.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.out_proj(self.norm(x)).reshape(B, h, w, self.out_dim)


class FeatureAutoencoder(VQAutoencoder):
    """Encoder + quant / post-quant projections + codebook + decoder over
    (B, grid, grid, n_channels) feature maps."""

    def __init__(self, n_channels: int, grid: int, latent_dim: int = 32, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, vq_cfg: VQConfig = None):
        super().__init__()
        self.n_channels = n_channels
        self.latent_grid = (grid, grid)
        self.encoder = FeatureViT(n_channels, dim, grid, dim, depth, num_heads)
        self.decoder = FeatureViT(dim, n_channels, grid, dim, depth, num_heads)
        self.quant_proj = Linear(dim, latent_dim)
        self.post_quant_proj = Linear(latent_dim, dim)
        self.quantize = Quantizer(vq_cfg or VQConfig(dim=latent_dim))


class FeatureVQTokenizer(VQTokenizer):
    """tokenize / decode_tokens / autoencode on (B, h, w, d) teacher feature
    maps; tokens are (B, h, w)."""


def feature_vqvae_from_config(domain: str, generator: torch.Generator = None,
                              codebook_size: int = 8192, latent_dim: int = 32,
                              ema_decay: float = 0.99, threshold_ema_dead_code: float = 2.0,
                              commitment_weight: float = 1.0, kmeans_init: bool = False,
                              code_replacement_policy: str = "batch_random",
                              norm_codes: bool = True, dim: int = 768, depth: int = 12,
                              num_heads: int = 12, device=None) -> FeatureVQTokenizer:
    """A feature-domain tokenizer on `device` (random weights from
    `generator`, or zeros to be loaded over); the feature width and grid
    come from the teacher registry (models/teachers.py:TEACHER_SPECS)."""
    from egom2p_torch.models.teachers import TEACHER_SPECS

    spec = TEACHER_SPECS[domain]
    vq_cfg = VQConfig(codebook_size=codebook_size, dim=latent_dim, decay=ema_decay,
                      threshold_ema_dead_code=threshold_ema_dead_code,
                      commitment_weight=commitment_weight, use_cosine_sim=norm_codes,
                      kmeans_init=kmeans_init, code_replacement_policy=code_replacement_policy)
    net = FeatureAutoencoder(spec.feat_dim, 1 if spec.global_pool else spec.grid, latent_dim,
                             dim, depth, num_heads, vq_cfg)
    if device is not None:
        net = net.to(device)
    if generator is not None:
        net.init_random_(generator)
    return FeatureVQTokenizer(net)
