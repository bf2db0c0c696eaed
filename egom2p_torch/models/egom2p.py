"""EgoM2P: masked multimodal multitask encoder-decoder.

Port of egom2p_tpu/models/egom2p.py (reference:
egom2p/models/egom2p_model.py:57-819): per-modality embeddings, the
deterministic argsort-gather of the encoder and decoder tokens to fixed
counts, the encoder and decoder stacks, the per-modality vocab head, the
training forward with its 'mod' / 'weighted_mod' / 'token' losses, and the
generation hooks.  Parameters are fp32; activations run in
`config.compute_dtype` (bf16 by default; pass "float32" for exact-math
parity tests).

Not ported yet: sequence-type decoder modalities and the causal decoder
(`adapt_decoder_attention_mask`), the autoregressive logits, register tokens
and unshared modality embeddings (the released models use none of them).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from egom2p_torch.data.modality_info import MODALITY_INFO
from egom2p_torch.models.embeddings import (make_decoder_embedding,
                                            make_encoder_embedding)
from egom2p_torch.models.transformer import (ACTIVATIONS, Block, DecoderBlock,
                                             LayerNorm, Linear)
from egom2p_torch.ops.attention import SegmentMask
from egom2p_torch.ops.flash_ce import flash_ce_total, matmul_f32
from egom2p_torch.ops.flash_ce import takes_dim as flash_ce_takes_dim

SEQ_TYPES = ("seq", "seq_emb", "seq_token")


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


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

    # ------------------------------------------------------- decoder masking
    def embed_decoder(self, mod_dict, compute_dtype=None) -> List[Dict[str, Any]]:
        """Per-modality decoder inputs and targets, in sorted modality order:
        dicts with mod / x / emb / ids / mask / attn.  Image-type decoder
        inputs are the mask token (reference: egom2p_model.py:285-342)."""
        compute_dtype = compute_dtype or self.compute_dtype
        out = []
        for mod in sorted(self.out_domains):
            if mod not in mod_dict:
                continue
            if self.mod_info[mod]["type"] in SEQ_TYPES:
                raise NotImplementedError(
                    f"decoder modality {mod}: sequence-type targets are not ported yet")
            d = mod_dict[mod]
            x, emb, ids = self.decoder_embeddings[mod].forward_embed(d, compute_dtype)
            out.append(dict(mod=mod, x=self.mask_token.to(x.dtype).expand(x.shape),
                            emb=emb, ids=ids, mask=d["target_mask"].bool(),
                            attn=d["decoder_attention_mask"].int()))
        return out

    def forward_mask_decoder(self, dec_embeds, num_decoder_tokens: int,
                             perm: Optional[torch.Tensor] = None):
        """Concat + argsort-gather to a fixed token count, the modalities
        ordered by `perm` (a permutation of range(len(dec_embeds)); None
        keeps sorted order) through per-modality tie-break offsets
        (reference: egom2p_model.py:398-444).  Returns (tokens, emb,
        decoder_mask (B, 1, M), target ids, self-attention mask, mod ids)."""
        info = self.mod_info
        device = dec_embeds[0]["x"].device
        lengths = [e["x"].shape[1] for e in dec_embeds]
        tokens = torch.cat([e["x"] for e in dec_embeds], dim=1)
        emb = torch.cat([e["emb"] for e in dec_embeds], dim=1)
        mask = torch.cat([e["mask"] for e in dec_embeds], dim=1)
        ids = torch.cat([e["ids"] for e in dec_embeds], dim=1)
        mod_ids = torch.cat([
            torch.full(e["x"].shape[:2], info[e["mod"]]["id"], dtype=torch.int32,
                       device=device) for e in dec_embeds], dim=1)

        lens = torch.tensor(lengths, dtype=torch.float32, device=device)
        within = torch.cat([torch.arange(n, dtype=torch.float32, device=device)
                            for n in lengths])[None]
        if perm is not None and len(dec_embeds) > 1:
            perm = perm.to(device)
            offset_per_mod = _exclusive_cumsum(lens[perm])[torch.argsort(perm)]
        else:
            offset_per_mod = _exclusive_cumsum(lens)
        mod_index = torch.cat([torch.full((n,), i, dtype=torch.long, device=device)
                               for i, n in enumerate(lengths)])
        base = offset_per_mod[mod_index][None]
        # fp32, epsilon 1e-6 and a stable sort, exactly as the JAX package:
        # any other rounding reorders ties
        prio = mask.float() + (base + within) * 1e-6
        ids_keep = torch.argsort(prio, dim=1, stable=True)[:, :num_decoder_tokens]

        def take(a):
            if a.dim() == 3:
                return torch.gather(a, 1, ids_keep[..., None].expand(-1, -1, a.shape[-1]))
            return torch.gather(a, 1, ids_keep)

        tokens_k, emb_k, mask_k = take(tokens), take(emb), take(mask)
        ids_k, mod_k = take(ids), take(mod_ids)
        tokens_k = tokens_k.masked_fill(mask_k[..., None], 0.0)
        emb_k = emb_k.masked_fill(mask_k[..., None], 0.0)
        ids_k = ids_k.masked_fill(mask_k, 0)
        mod_k = mod_k.masked_fill(mask_k, -1)
        # image-type modalities only (embed_decoder): the cumsum + separation
        # mask reduces exactly to "attend within your own modality"
        sa_mask = SegmentMask(segments=mod_k)
        return tokens_k, emb_k, mask_k[:, None, :], ids_k, sa_mask, mod_k

    # ------------------------------------------------------------- backbones
    def forward_encoder(self, x, encoder_mask):
        for blk in self.encoder:
            x = blk(x, encoder_mask)
        return self.encoder_norm(x)

    def forward_decoder(self, y, context, encoder_mask, sa_mask=None):
        for blk in self.decoder:
            y = blk(y, context, sa_mask, encoder_mask)
        return self.decoder_norm(y)

    # ------------------------------------------------------------------ loss
    def _chunked_masked_ce(self, y, mod: str, target_ids, weights, chunk: int = 2048):
        """(sum of CE * w, sum of w) of modality `mod`'s head over the
        decoder rows.  Heads of 4096 or more tokens take flash_ce_total (its
        hand-written kernel on CUDA: no (rows, V) logits in device memory)
        when flash_ce.takes_dim says the kernels take the model dim (a
        multiple of 128: not EgoM2P-large's 1020, as in the JAX package; the
        kernels' launchers decide by the same function); EGOM2P_FLASH_CE=0
        turns it off.  Other heads take a plain logsumexp over chunks of
        rows, each chunk under torch.utils.checkpoint: its (chunk, V) fp32
        logits are recomputed in the backward, not kept (the JAX package's
        jax.checkpoint around its scan body).  The logits product goes
        through flash_ce.matmul_f32: its operands are bf16 values widened to
        fp32, exact in TF32, so on the card the product and its recompute run
        on the TF32 tensor cores with the same numbers.  EGOM2P_CE_CHUNK
        overrides the chunk."""
        chunk = int(os.environ.get("EGOM2P_CE_CHUNK", "0")) or chunk
        flash = os.environ.get("EGOM2P_FLASH_CE", "1") != "0"
        emb_mod = self.decoder_embeddings[mod]
        D = y.shape[-1]
        yf = y.reshape(-1, D)
        w = weights.reshape(-1).float()
        # other modalities' targets can exceed this head's vocab: zero them
        t = torch.where(weights.reshape(-1), target_ids.reshape(-1),
                        torch.zeros_like(target_ids.reshape(-1)))
        if flash and emb_mod.vocab_size >= 4096 and flash_ce_takes_dim(D):
            return flash_ce_total(yf, emb_mod.token_emb.weight, t, w, chunk=chunk), w.sum()
        head_t = emb_mod.head_weight(y.dtype).t()
        bf16_values = y.dtype == torch.bfloat16

        def chunk_total(y_c, t_c, w_c):
            logits = matmul_f32(y_c, head_t, bf16_values=bf16_values)
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(1, t_c.long()[:, None])[:, 0]
            return ((logz - gold) * w_c).sum()

        total = yf.new_zeros((), dtype=torch.float32)
        for r0 in range(0, yf.shape[0], chunk):
            total = total + checkpoint(chunk_total, yf[r0:r0 + chunk], t[r0:r0 + chunk],
                                       w[r0:r0 + chunk], use_reentrant=False)
        return total, w.sum()

    def forward_loss(self, y, target_ids, decoder_mod_mask, loss_type: str,
                     present_mods: List[str]):
        """'mod' / 'weighted_mod' / 'token' losses
        (reference: egom2p_model.py:553-680)."""
        info = self.mod_info
        mod_loss: Dict[str, torch.Tensor] = {}
        mod_count: Dict[str, torch.Tensor] = {}
        for mod in present_mods:
            w = decoder_mod_mask == info[mod]["id"]
            total, count = self._chunked_masked_ce(y, mod, target_ids, w)
            loss_m = torch.where(count > 0, total / count.clamp(min=1.0),
                                 torch.zeros_like(total))
            if loss_type == "weighted_mod":
                # rescale as if every modality had a 256-entry codebook
                # (reference: egom2p_model.py:608)
                loss_m = loss_m / math.log(info[mod]["vocab_size"]) * math.log(256.0)
            mod_loss[mod] = loss_m
            mod_count[mod] = count

        if loss_type in ("mod", "modality", "weighted_mod"):
            loss = sum(mod_loss.values()) / len(mod_loss)
        elif loss_type == "token":
            # the reference weights modalities by logits.numel() =
            # n_tokens * vocab_size (egom2p_model.py:676)
            weights = {m: mod_count[m] * info[m]["vocab_size"] for m in mod_loss}
            denom = sum(weights.values()).clamp(min=1.0)
            loss = sum(mod_loss[m] * weights[m] for m in mod_loss) / denom
        else:
            raise ValueError(f"Invalid loss type: {loss_type}")
        return loss, mod_loss

    # --------------------------------------------------------------- forward
    def forward(self, mod_dict, num_encoder_tokens: int, num_decoder_tokens: int,
                loss_type: str = "mod", shuffle: Optional[torch.Generator] = None,
                compute_dtype=None):
        """Training forward (reference: egom2p_model.py:683-734): returns
        (loss, {mod: loss}).  The decoder's modality order is a permutation
        drawn from the CPU generator `shuffle`, or sorted order."""
        compute_dtype = compute_dtype or self.compute_dtype
        enc_embeds = self.embed_encoder(mod_dict, compute_dtype)
        encoder_tokens, encoder_emb, encoder_mask, _ = self.forward_mask_encoder(
            enc_embeds, num_encoder_tokens)

        dec_embeds = self.embed_decoder(mod_dict, compute_dtype)
        perm = None if shuffle is None else torch.randperm(len(dec_embeds), generator=shuffle)
        decoder_tokens, decoder_emb, _, target_ids, sa_mask, dec_mod_mask = \
            self.forward_mask_decoder(dec_embeds, num_decoder_tokens, perm)

        x = self.forward_encoder(encoder_tokens + encoder_emb, encoder_mask)
        context = self.decoder_proj_context(x) + encoder_emb
        y = self.forward_decoder(decoder_tokens + decoder_emb, context, encoder_mask, sa_mask)
        return self.forward_loss(y, target_ids, dec_mod_mask, loss_type,
                                 [e["mod"] for e in dec_embeds])

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
