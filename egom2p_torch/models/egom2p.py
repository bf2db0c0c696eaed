"""EgoM2P: masked multimodal multitask encoder-decoder, inference forward.

Port of the generation hooks of egom2p_tpu/models/egom2p.py (reference:
egom2p/models/egom2p_model.py:57-819): per-modality embeddings, the
deterministic argsort-gather of the encoder tokens to a fixed count, the
encoder and decoder stacks, and the per-modality vocab head.  Parameters are
fp32; activations run in `config.compute_dtype` (bf16 by default; pass
"float32" for exact-math parity tests).

Not ported yet: the training losses, the decoder-side masking for training,
the autoregressive logits, register tokens and unshared modality
embeddings (the released models use neither).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from egom2p_torch.data.modality_info import MODALITY_INFO
from egom2p_torch.models.embeddings import (make_decoder_embedding,
                                            make_encoder_embedding)
from egom2p_torch.models.transformer import (ACTIVATIONS, Block, DecoderBlock,
                                             LayerNorm, Linear)


@dataclasses.dataclass(frozen=True)
class EgoM2PConfig:
    dim: int = 768
    encoder_depth: int = 12
    decoder_depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    proj_bias: bool = True
    mlp_bias: bool = True
    norm_bias: bool = True
    gated_mlp: bool = False
    qk_norm: bool = False
    act: str = "gelu"
    compute_dtype: str = "bfloat16"


class EgoM2P(nn.Module):
    def __init__(self, config: EgoM2PConfig, in_domains, out_domains,
                 modality_info: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.config = config
        self.in_domains = tuple(in_domains)
        self.out_domains = tuple(out_domains)
        self.mod_info = modality_info if modality_info is not None else MODALITY_INFO
        cfg, info = config, self.mod_info

        self.encoder_embeddings = nn.ModuleDict({
            mod: make_encoder_embedding(info[mod]["embed_spec"], cfg.dim)
            for mod in sorted(self.in_domains)})
        self.decoder_embeddings = nn.ModuleDict({
            mod: make_decoder_embedding(info[mod]["embed_spec"], cfg.dim)
            for mod in sorted(self.out_domains)})
        # one modality embedding per modality, shared encoder <-> decoder
        # (reference: egom2p_model.py:179-183)
        for mod in self.decoder_embeddings:
            if mod in self.encoder_embeddings:
                self.decoder_embeddings[mod].mod_emb = self.encoder_embeddings[mod].mod_emb

        act = ACTIVATIONS[cfg.act]
        common = dict(mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                      proj_bias=cfg.proj_bias, mlp_bias=cfg.mlp_bias,
                      norm_bias=cfg.norm_bias, gated_mlp=cfg.gated_mlp,
                      qk_norm=cfg.qk_norm, act=act)
        self.encoder = nn.ModuleList([Block(cfg.dim, cfg.num_heads, **common)
                                      for _ in range(cfg.encoder_depth)])
        self.encoder_norm = LayerNorm(cfg.dim, bias=cfg.norm_bias)
        self.decoder = nn.ModuleList([DecoderBlock(cfg.dim, cfg.num_heads, **common)
                                      for _ in range(cfg.decoder_depth)])
        self.decoder_norm = LayerNorm(cfg.dim, bias=cfg.norm_bias)
        self.decoder_proj_context = Linear(cfg.dim, cfg.dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.dim))

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.config.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.mask_token.device

    # ------------------------------------------------------------ random init
    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "EgoM2P":
        """Random weights from `generator` (on the model's device): normal
        0.02 for embeddings and the mask token, lecun-normal (std
        fan_in^-0.5) for linear layers, ones/zeros for norms."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("mod_emb", "mask_token") or name.endswith("token_emb.weight"):
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf == "bias":
                p.zero_()
            elif p.dim() == 1:  # norm scales
                p.fill_(1.0)
            else:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
        return self

    # ------------------------------------------------------- encoder masking
    def embed_encoder(self, mod_dict, compute_dtype=None):
        """Per-modality encoder embeddings in sorted modality order:
        [(mod, x, emb, input_mask)]."""
        compute_dtype = compute_dtype or self.compute_dtype
        out = []
        for mod in sorted(self.in_domains):
            if mod not in mod_dict:
                continue
            x, emb = self.encoder_embeddings[mod](mod_dict[mod], compute_dtype)
            out.append((mod, x, emb, mod_dict[mod]["input_mask"]))
        return out

    def forward_mask_encoder(self, enc_embeds, num_encoder_tokens: int):
        """Concat + deterministic argsort-gather to a fixed token count
        (reference: egom2p_model.py:344-396).  Returns (tokens, emb,
        encoder_mask (B, 1, N) with True = blocked key, mod ids)."""
        info = self.mod_info
        tokens = torch.cat([x for _, x, _, _ in enc_embeds], dim=1)
        emb = torch.cat([e for _, _, e, _ in enc_embeds], dim=1)
        mask = torch.cat([m for _, _, _, m in enc_embeds], dim=1).bool()
        mod_ids = torch.cat([
            torch.full(x.shape[:2], info[mod]["id"], dtype=torch.int32,
                       device=x.device)
            for mod, x, _, _ in enc_embeds], dim=1)

        O = mask.shape[1]
        # epsilon tie-break keeps unmasked tokens first, in concat order
        prio = mask.float() + torch.arange(O, dtype=torch.float32,
                                           device=mask.device)[None] * 1e-6
        ids_keep = torch.argsort(prio, dim=1, stable=True)[:, :num_encoder_tokens]

        def take(a):
            if a.dim() == 3:
                return torch.gather(a, 1, ids_keep[..., None].expand(-1, -1, a.shape[-1]))
            return torch.gather(a, 1, ids_keep)

        tokens_k, emb_k, mask_k, mod_k = take(tokens), take(emb), take(mask), take(mod_ids)
        tokens_k = tokens_k.masked_fill(mask_k[..., None], 0.0)
        emb_k = emb_k.masked_fill(mask_k[..., None], 0.0)
        mod_k = mod_k.masked_fill(mask_k, -1)
        return tokens_k, emb_k, mask_k[:, None, :], mod_k

    # ------------------------------------------------------------- backbones
    def forward_encoder(self, x, encoder_mask):
        for blk in self.encoder:
            x = blk(x, encoder_mask)
        return self.encoder_norm(x)

    def forward_decoder(self, y, context, encoder_mask, sa_mask=None):
        for blk in self.decoder:
            y = blk(y, context, sa_mask, encoder_mask)
        return self.decoder_norm(y)

    # ------------------------------------------------------ generation hooks
    def forward_enc_context(self, mod_dict, num_encoder_tokens: int,
                            compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encoder pass + context projection, for the generation sampler.
        Returns (context (B, N, D), encoder_mask (B, 1, N))."""
        enc_embeds = self.embed_encoder(mod_dict, compute_dtype)
        tokens, emb, encoder_mask, _ = self.forward_mask_encoder(
            enc_embeds, num_encoder_tokens)
        x = self.forward_encoder(tokens + emb, encoder_mask)
        return self.decoder_proj_context(x) + emb, encoder_mask

    def forward_dec_subset_hidden(self, mod_dict, target_mod: str, context,
                                  encoder_mask, ids_keep: torch.Tensor,
                                  compute_dtype=None) -> torch.Tensor:
        """Decoder pass over the chosen still-masked target positions
        `ids_keep` (B, k), up to the hidden states before the vocab head
        (reference: egom2p/models/generate.py:630-650, 747-766)."""
        compute_dtype = compute_dtype or self.compute_dtype
        emb_mod = self.decoder_embeddings[target_mod]
        B, k = ids_keep.shape
        emb = emb_mod.positional(B, compute_dtype)
        dec_emb = torch.gather(emb, 1, ids_keep.long()[..., None].expand(-1, -1, emb.shape[-1]))
        y = self.mask_token.to(dec_emb.dtype) + dec_emb
        return self.forward_decoder(y, context, encoder_mask, None)

    def forward_mod_logits(self, target_mod: str, y, head_weight=None) -> torch.Tensor:
        """fp32 vocab-head logits of one modality over decoder hidden states;
        the sampler applies it to position chunks."""
        return self.decoder_embeddings[target_mod].forward_logits(y, head_weight)


# ----------------------------------------------------------------- registry
def _cfg(depth, dim, heads, **kw):
    return dict(encoder_depth=depth, decoder_depth=depth, dim=dim, num_heads=heads, **kw)


_GELU = dict(mlp_ratio=4.0, qkv_bias=True, act="gelu")
_SWIGLU = dict(mlp_ratio=4.0, qkv_bias=False, proj_bias=False, mlp_bias=False,
               norm_bias=False, act="silu", gated_mlp=True)

# (reference: egom2p_model.py:882-1196); the causal-decoder variant waits
# for the autoregressive decoder path
MODEL_REGISTRY: Dict[str, Dict[str, Any]] = {
    "egom2p_tiny_6e_6d_gelu": _cfg(6, 384, 6, **_GELU),
    "egom2p_small_8e_8d_gelu": _cfg(8, 512, 8, **_GELU),
    "egom2p_base_12e_12d_gelu": _cfg(12, 768, 12, **_GELU),
    "egom2p_large_24e_24d_gelu": _cfg(24, 1024, 16, **_GELU),
    "egom2p_xlarge_24e_24d_gelu": _cfg(24, 2048, 32, **_GELU),
    "egom2p_tiny_6e_6d_swiglu_nobias": _cfg(6, 384, 6, **_SWIGLU),
    "egom2p_small_8e_8d_swiglu_nobias": _cfg(8, 512, 8, **_SWIGLU),
    "egom2p_base_12e_12d_swiglu_nobias": _cfg(12, 768, 12, **_SWIGLU),
    "egom2p_large_24e_24d_swiglu_nobias": _cfg(24, 1020, 15, **_SWIGLU),
    "egom2p_xlarge_24e_24d_swiglu_nobias": _cfg(24, 2046, 31, **_SWIGLU),
    "egom2p_base_12e_12d_swiglu_qknorm_nobias": _cfg(12, 768, 12, qk_norm=True, **_SWIGLU),
    "egom2p_large_24e_24d_swiglu_qknorm_nobias": _cfg(24, 1024, 16, qk_norm=True, **_SWIGLU),
    "egom2p_xlarge_24e_24d_swiglu_qknorm_nobias": _cfg(24, 2048, 32, qk_norm=True, **_SWIGLU),
}


def create_model(name: str, in_domains, out_domains, modality_info=None,
                 device=None, **overrides) -> EgoM2P:
    """Model factory matching the reference registry names
    (reference: egom2p/utils/timm/model_builder.py:27)."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model {name}; available: {list(MODEL_REGISTRY)}")
    kw = dict(MODEL_REGISTRY[name])
    kw.update(overrides)
    model = EgoM2P(EgoM2PConfig(**kw), in_domains=in_domains,
                   out_domains=out_domains, modality_info=modality_info)
    return model.to(device) if device is not None else model
