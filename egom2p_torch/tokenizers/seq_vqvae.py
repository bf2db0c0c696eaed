"""Camera-trajectory / gaze transformer VQ-VAE tokenizers (inference).

Port of egom2p_tpu/tokenizers/seq_vqvae.py (reference: egom2p/vq/vqvae.py,
egom2p/vq/models/{cam,gaze}_transformer.py):

  * encoder: a strided Conv1d "patchify" (kernel = stride = the temporal
    compression, 2 in the released configs) -> 1-D sincos posemb -> ViT
    blocks -> a residual post-MLP with tanh (cam_transformer.py:153-225);
    the gaze encoder multiplies the data by its validity channel first
    (gaze_transformer.py:212-215);
  * quant_proj / post_quant_proj: 1x1 Conv1d layers (vqvae.py:166, 430),
    applied as products on the channel-last layout;
  * the cosine-sim codebook (ops/vq.py) as the reference's
    `quantize._codebook` buffers;
  * decoder: the encoder's mirror, then each latent step projected back to
    `temporal_compress` frames, channel-major in the projected columns
    ('b nt (c pt) -> b (nt pt) c', cam_transformer.py:305-323).

Module and buffer names are the reference's state-dict keys, so a
reference .pth loads with a key-checked copy (core/checkpoint.py).  The
tokenizer computes in fp32, as the JAX package's default; on the card its
products run in exact fp32 unless `SeqTokenizer.tf32` allows TF32.

Training: `VQAutoencoder.autoencode_train` (the base this file shares with
the video and feature VQ-VAEs) is the forward of the JAX train
step (egom2p_tpu/train/vqvae_train.py:make_vqvae_train_step): it quantizes
through ops/vq.py:vq_forward under the codebook as it was, then writes the
updated codebook (EMA statistics, expired codes replaced) into the buffers;
train/vqvae_train.py builds the step around it.

Shapes of the released configs: cam (B, 60, 9) -> 30 tokens of 256 codes;
gaze (B, 60, 3) (x, y, valid) -> 30 tokens, decoded to (B, 60, 2).

The gradient-trained quantizers (the reference's `quant_type`, vqvae.py:
169-198): `GradVQAutoencoder` wraps any of these cores (sequence, video or
feature) around a taming VQ or Memcodes quantizer of ops/quantizers.py,
whose codebook is a parameter the optimizer trains; the core's EMA codebook
buffers are dropped.  Its state dict is the JAX tree's, key for key:
`core.<the core's keys>` and `quantizer.embedding.weight` (taming) or
`quantizer.{codes,to_k,to_v}` (Memcodes).  Tokens are flat per sample
((B, N), or (B, heads, N) for Memcodes with several heads), as in JAX;
`decode_tokens` restores the core's latent grid, the feature core's (h, w)
included (JAX's hands the feature core a flat latent and raises there).
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from egom2p_torch.models.transformer import Block, LayerNorm, Linear, Mlp
from egom2p_torch.ops.posemb import build_1d_sincos_posemb
from egom2p_torch.ops.quantizers import Memcodes, TamingVectorQuantizer
from egom2p_torch.ops.vq import (VQConfig, VQState, indices_to_embedding, init_vq_state,
                                 vq_forward, vq_lookup)

# domain -> (data channels, whether a validity channel masks the input)
DOMAINS = {"cam": (9, False), "gaze": (2, True)}
MLP_RATIO = 4.0


class Conv1x1(nn.Conv1d):
    """A kernel-1 Conv1d (the reference's weight (out, in, 1)) applied to
    channel-last (..., in) input as a product."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, kernel_size=1)

    def forward(self, x):
        return F.linear(x, self.weight[..., 0], self.bias)


class PatchConv1d(nn.Conv1d):
    """The strided temporal patchify, kernel = stride = `t`: (B, T, C) ->
    (B, T / t, dim), as one product over each window of t frames."""

    def __init__(self, in_channels: int, dim: int, t: int):
        super().__init__(in_channels, dim, kernel_size=t, stride=t)

    def forward(self, x):
        b, n, c = x.shape
        t = self.kernel_size[0]
        windows = x[:, :n // t * t].reshape(b, n // t, t, c)  # (b, n', k, c)
        weight = self.weight.permute(0, 2, 1).reshape(self.out_channels, t * c)
        return F.linear(windows.reshape(b, n // t, t * c), weight, self.bias)


class _SeqTrunk(nn.Module):
    """posemb -> blocks -> residual tanh post-MLP, shared by both halves
    (the released configs' post_mlp=True, mlp_ratio 4)."""

    def __init__(self, n_tok: int, dim: int, depth: int, num_heads: int):
        super().__init__()
        self.register_buffer("pos", torch.from_numpy(build_1d_sincos_posemb(n_tok, dim)),
                             persistent=False)
        self.blocks = nn.ModuleList(Block(dim, num_heads, MLP_RATIO, qkv_bias=True)
                                    for _ in range(depth))
        self.norm_mlp = LayerNorm(dim)
        self.post_mlp = Mlp(dim, int(MLP_RATIO * dim), act=torch.tanh)

    def trunk(self, x):
        x = x + self.pos.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return x + self.post_mlp(self.norm_mlp(x))


class SeqEncoder(_SeqTrunk):
    """(B, T, C) -> (B, T / tc, dim) (reference: cam_transformer.py:131-225)."""

    def __init__(self, in_channels: int, num_frames: int = 60, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, temporal_compress: int = 2,
                 mask_input: bool = False):
        super().__init__(num_frames // temporal_compress, dim, depth, num_heads)
        self.in_channels = in_channels
        self.mask_input = mask_input
        self.conv = PatchConv1d(in_channels, dim, temporal_compress)

    def forward(self, x):
        if self.mask_input:  # (B, T, C + 1): the last channel is the validity mask
            x = x[..., :self.in_channels] * x[..., self.in_channels:]
        return self.trunk(self.conv(x))


class SeqDecoder(_SeqTrunk):
    """(B, T / tc, dim) -> (B, T, C) (reference: cam_transformer.py:228-323)."""

    def __init__(self, out_channels: int, num_frames: int = 60, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, temporal_compress: int = 2):
        super().__init__(num_frames // temporal_compress, dim, depth, num_heads)
        self.out_channels = out_channels
        self.temporal_compress = temporal_compress
        self.out_proj = Linear(dim, out_channels * temporal_compress)

    def forward(self, x):
        x = self.out_proj(self.trunk(x))
        b, nt, _ = x.shape
        # 'b nt (c pt) -> b (nt pt) c'
        x = x.reshape(b, nt, self.out_channels, self.temporal_compress)
        return x.transpose(2, 3).reshape(b, nt * self.temporal_compress, self.out_channels)


class Codebook(nn.Module):
    """The codebook buffers under the reference's names
    (`quantize._codebook.{embed,cluster_size,initted}`)."""

    def __init__(self, cfg: VQConfig):
        super().__init__()
        self.register_buffer("embed", torch.zeros(cfg.codebook_size, cfg.dim))
        self.register_buffer("cluster_size", torch.zeros(cfg.codebook_size))
        self.register_buffer("initted", torch.zeros(1))


class Quantizer(nn.Module):
    def __init__(self, cfg: VQConfig):
        super().__init__()
        self.cfg = cfg
        self._codebook = Codebook(cfg)

    @property
    def state(self) -> VQState:
        cb = self._codebook
        return VQState(embed=cb.embed, cluster_size=cb.cluster_size, initted=cb.initted)

    @torch.no_grad()
    def set_state(self, state: VQState) -> None:
        for name in ("embed", "cluster_size", "initted"):
            buf = getattr(self._codebook, name)
            buf.copy_(getattr(state, name).reshape(buf.shape).to(buf))


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from `generator` (on the module's device), as flax's
    defaults: lecun-normal (std fan_in^-0.5) weights, zero biases, unit
    norm scales."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    return module


class VQAutoencoder(nn.Module):
    """What the EMA-codebook VQ-VAEs share (this file's SeqAutoencoder,
    tokenizers/video_vqvae.py, tokenizers/feature_vqvae.py): an `encoder`,
    `quant_proj`, the `quantize` codebook buffers, `post_quant_proj`, a
    `decoder`, `n_channels`, the data's channels (the target's without
    gaze's validity channel), and `latent_grid`, the latent's shape per
    sample without its channels.  Latents are channel-last (B, ...,
    latent_dim): a sequence, a (t, h, w) or an (h, w) grid; the codebook sees
    them flattened in row-major order, as the JAX train step reshapes them."""

    n_channels: int
    latent_grid: Tuple[int, ...]

    def encode_latents(self, x):
        return self.quant_proj(self.encoder(x))

    def decode_latents(self, quant):
        return self.decoder(self.post_quant_proj(quant))

    def autoencode_train(self, x, **draws):
        """(B, ...) -> (reconstruction, commitment loss, tokens (B, ...)),
        differentiable, as the JAX train step's loss computes them
        (egom2p_tpu/train/vqvae_train.py:77-89): the decoder sees the codes
        of the codebook as it was before this batch; the codebook buffers
        then take the batch's update.  `draws` go to
        vq_forward (`generator`, or `replace_idx` / `lbg_noise`: without
        them no code expires; and a process group's `stats_reduce`,
        `pool_gather` and `world`)."""
        lat = self.encode_latents(x)
        quant, commit, tokens, new_state = vq_forward(self.quantize.cfg, self.quantize.state,
                                                      lat, **draws)
        self.quantize.set_state(new_state)
        return self.decode_latents(quant), commit, tokens

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "VQAutoencoder":
        """Random weights from `generator` (on the module's device), as
        flax's defaults: lecun-normal (std fan_in^-0.5) weights, zero
        biases, unit norm scales; a fresh codebook (ops/vq.py)."""
        init_weights_(self, generator)
        self.quantize.set_state(init_vq_state(self.quantize.cfg, generator,
                                              device=self.quantize._codebook.embed.device))
        return self


class SeqAutoencoder(VQAutoencoder):
    """Encoder + quant / post-quant projections + codebook + decoder."""

    def __init__(self, n_channels: int, num_frames: int = 60, latent_dim: int = 32,
                 temporal_compress: int = 2, mask_input: bool = False, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, vq_cfg: VQConfig = None):
        super().__init__()
        self.n_channels = n_channels
        self.latent_grid = (num_frames // temporal_compress,)
        self.encoder = SeqEncoder(n_channels, num_frames, dim, depth, num_heads,
                                  temporal_compress=temporal_compress, mask_input=mask_input)
        self.decoder = SeqDecoder(n_channels, num_frames, dim, depth, num_heads,
                                  temporal_compress=temporal_compress)
        self.quant_proj = Conv1x1(dim, latent_dim)
        self.post_quant_proj = Conv1x1(latent_dim, dim)
        self.quantize = Quantizer(vq_cfg or VQConfig(dim=latent_dim))


class VQTokenizer:
    """Bundles a VQAutoencoder (fp32, eval mode) with the user-facing calls
    of the reference's VQVAE (vqvae.py:285-362): encode / tokenize /
    decode_tokens / autoencode.  Inputs may be numpy or tensors on any
    device; outputs are tensors on the tokenizer's device."""

    def __init__(self, net: VQAutoencoder):
        self.net = net.float().eval()
        # whether the card's fp32 products may run on TF32 while the tokenizer
        # computes; the JAX default is exact fp32
        self.tf32 = False

    @property
    def device(self) -> torch.device:
        return self.net.quantize._codebook.embed.device

    @property
    def vq_cfg(self) -> VQConfig:
        return self.net.quantize.cfg

    @property
    def vq_state(self) -> VQState:
        return self.net.quantize.state

    @contextlib.contextmanager
    def _precision(self):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            with torch.inference_mode():
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, torch.float32)

    def encode(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, ...) -> (quantized latents (B, ..., D), tokens (B, ...)):
        (B, T, C) -> (B, T', D), (B, T') for the sequence tokenizers."""
        with self._precision():
            lat = self.net.encode_latents(self._input(x))
            return vq_lookup(self.vq_cfg, self.vq_state, lat)

    def tokenize(self, x) -> torch.Tensor:
        return self.encode(x)[1]

    def decode_tokens(self, tokens) -> torch.Tensor:
        """(B, ...) token ids -> the decoded data, fp32."""
        with self._precision():
            quant = indices_to_embedding(self.vq_state, tokens)
            return self.net.decode_latents(quant)

    def autoencode(self, x) -> torch.Tensor:
        quant, _ = self.encode(x)
        with self._precision():
            return self.net.decode_latents(quant)


class SeqTokenizer(VQTokenizer):
    """A cam or gaze tokenizer: (B, T, C) -> (B, T') tokens."""


class GradVQAutoencoder(nn.Module):
    """An autoencoder core (a VQAutoencoder: sequence, video or feature)
    around a gradient-trained quantizer, the taming VQ or Memcodes
    (egom2p_tpu/tokenizers/seq_vqvae.py:GradVQAutoencoder; reference:
    egom2p/vq/vqvae.py:169-198).  The core's EMA codebook is removed: the
    quantizer's codebook is a parameter and learns by backprop."""

    def __init__(self, core: VQAutoencoder, quantizer_type: str, codebook_size: int,
                 latent_dim: int, num_codebooks: int = 1, beta: float = 0.25):
        super().__init__()
        if quantizer_type not in ("taming", "memcodes"):
            raise ValueError(f"unknown gradient quantizer {quantizer_type!r}")
        if hasattr(core, "quantize"):
            del core.quantize  # no EMA codebook to train, save or count
        self.core = core
        self.quantizer_type = quantizer_type
        self.codebook_size, self.latent_dim = codebook_size, latent_dim
        if quantizer_type == "taming":
            self.quantizer = TamingVectorQuantizer(codebook_size, latent_dim, beta=beta)
        else:
            self.quantizer = Memcodes(latent_dim, codebook_size, heads=num_codebooks)

    @property
    def n_channels(self) -> int:
        return self.core.n_channels

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "GradVQAutoencoder":
        """The core's weights as VQAutoencoder.init_random_ draws them, then
        the quantizer's (ops/quantizers.py: the JAX package's inits)."""
        init_weights_(self.core, generator)
        self.quantizer.init_random_(generator)
        return self

    def quantize(self, lat: torch.Tensor, training: bool = False, noise=None,
                 generator: torch.Generator = None):
        """Latents (B, ..., D) -> (quantized latents, quantizer loss,
        tokens): the latents flattened per sample, as in JAX.  `noise` /
        `generator`: Memcodes' gumbel draws at train time."""
        flat = lat.reshape(lat.shape[0], -1, lat.shape[-1])
        if self.quantizer_type == "taming":
            quant, qloss, (tokens, *_) = self.quantizer(flat, generator=generator)
        else:
            quant, qloss, tokens = self.quantizer(flat, training, noise, generator)
        return quant.reshape(lat.shape), qloss, tokens

    def autoencode_train(self, x, training: bool = False, noise=None,
                         generator: torch.Generator = None):
        """(B, ...) -> (reconstruction, quantizer loss, tokens),
        differentiable (the JAX train step's forward)."""
        quant, qloss, tokens = self.quantize(self.core.encode_latents(x), training, noise,
                                             generator)
        return self.core.decode_latents(quant), qloss, tokens

    def tokenize(self, x) -> torch.Tensor:
        return self.quantize(self.core.encode_latents(x))[2]

    def decode_tokens(self, tokens) -> torch.Tensor:
        if self.quantizer_type == "taming":
            quant = self.quantizer.get_codebook_entry(tokens)
        else:
            quant = self.quantizer.indices_to_embedding(tokens)
        quant = quant.reshape(quant.shape[0], *self.core.latent_grid, self.latent_dim)
        return self.core.decode_latents(quant)


class GradVQTokenizer(VQTokenizer):
    """A GradVQAutoencoder (fp32, eval mode) with tokenize / decode_tokens
    / autoencode (egom2p_tpu/tokenizers/seq_vqvae.py:GradVQTokenizer) and
    the user-facing calls of VQTokenizer."""

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def encode(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, ...) -> (quantized latents (B, ..., D), tokens)."""
        with self._precision():
            lat = self.net.core.encode_latents(self._input(x))
            quant, _, tokens = self.net.quantize(lat)
            return quant, tokens

    def decode_tokens(self, tokens) -> torch.Tensor:
        with self._precision():
            return self.net.decode_tokens(torch.as_tensor(tokens).to(self.device))

    def autoencode(self, x) -> torch.Tensor:
        quant, _ = self.encode(x)
        with self._precision():
            return self.net.core.decode_latents(quant)


def seq_vqvae_from_config(domain: str, generator: torch.Generator = None,
                          num_frames: int = 60, temporal_compress: int = 2,
                          codebook_size: int = 256, latent_dim: int = 32,
                          ema_decay: float = 0.99, threshold_ema_dead_code: float = 0.25,
                          commitment_weight: float = 1.0, kmeans_init: bool = False,
                          code_replacement_policy: str = "batch_random",
                          dim: int = 768, depth: int = 12, num_heads: int = 12,
                          device=None) -> SeqTokenizer:
    """A cam or gaze tokenizer at the released configs' widths by default
    (reference cfgs/default/tokenization/vqvae/{cam_traj,gaze}/*.yaml), on
    `device`: random weights from `generator` (on that device), or zeros
    to be loaded over when `generator` is None.  The quantizer's knobs are
    egom2p_tpu/tokenizers/seq_vqvae.py:seq_vqvae_from_config's; the
    codebook is cosine-sim, as there."""
    if domain not in DOMAINS:
        raise ValueError(f"unknown seq-vqvae domain {domain!r}")
    n_channels, mask_input = DOMAINS[domain]
    vq_cfg = VQConfig(codebook_size=codebook_size, dim=latent_dim, decay=ema_decay,
                      threshold_ema_dead_code=threshold_ema_dead_code,
                      commitment_weight=commitment_weight, use_cosine_sim=True,
                      kmeans_init=kmeans_init, code_replacement_policy=code_replacement_policy)
    net = SeqAutoencoder(n_channels, num_frames, latent_dim, temporal_compress, mask_input,
                         dim, depth, num_heads, vq_cfg)
    if device is not None:
        net = net.to(device)
    if generator is not None:
        net.init_random_(generator)
    return SeqTokenizer(net)
