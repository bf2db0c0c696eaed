"""EgoM2P: masked multimodal multitask encoder-decoder.

Port of egom2p_tpu/models/egom2p.py (reference:
egom2p/models/egom2p_model.py:57-819): per-modality embeddings, the
deterministic argsort-gather of the encoder and decoder tokens to fixed
counts, the encoder and decoder stacks, the per-modality vocab head, the
training forward with its 'mod' / 'weighted_mod' / 'token' losses, and the
generation hooks.  Parameters are fp32; activations run in
`config.compute_dtype` (bf16 by default; pass "float32" for exact-math
parity tests).

Also as in the JAX package: `num_register_tokens` learned tokens prepended
to the encoder's sequence (live keys of every attention that reads it),
stochastic depth per sample on every residual branch
(`drop_path_rate_encoder` / `_decoder`, a linspace over the blocks, masks
drawn from the forward's CPU generator before each block runs), and
activation checkpointing of every encoder and decoder block
(`use_act_checkpoint`): `remat_policy` "full" recomputes the whole block in
the backward, "dots" keeps the outputs of the unbatched products (aten.mm
and aten.addmm: jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
and recomputes the rest.  The hand-written attention kernels are
autograd.Functions around calls the dispatcher does not see, so under
either policy their forward runs again in the backward: a remat step
launches the attention forward twice per call.

Sequence modalities (captions): a sequence target is next-token
prediction (its decoder inputs are its own tokens shifted right, its
targets the tokens shifted left), and the decoder's self-attention mask is
then the dense (B, M, M) mask `adapt_decoder_attention_mask` rebuilds from
the cumsum-compressed encoding, or the causal mask of the `_causal`
registry model, each OR'd with the modality separation mask where
`decoder_sep_mask` asks for it; only image-type targets with the
separation mask and no causal mask take the segment mask (the attention
kernels).  `forward_dec_autoregressive_hidden` / `_logits` re-run the
decoder over a fixed-shape output prefix under a causal mask, for the
sampler's autoregressive path.  `share_modality_embeddings=False` gives
the decoder its own modality embeddings (`dec_mod_emb_*` in the JAX
package).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
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
    decoder_causal_mask: bool = False
    decoder_sep_mask: bool = True
    num_register_tokens: int = 0
    share_modality_embeddings: bool = True
    drop_path_rate_encoder: float = 0.0
    drop_path_rate_decoder: float = 0.0
    use_act_checkpoint: bool = False
    remat_policy: str = "full"  # or "dots"
    compute_dtype: str = "bfloat16"


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of the unbatched products, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


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
        # (reference: egom2p_model.py:179-183), unless the config unshares them
        for mod in self.decoder_embeddings:
            if cfg.share_modality_embeddings and mod in self.encoder_embeddings:
                self.decoder_embeddings[mod].mod_emb = self.encoder_embeddings[mod].mod_emb

        if cfg.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy {cfg.remat_policy!r}: 'full' or 'dots'")
        act = ACTIVATIONS[cfg.act]
        common = dict(mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                      proj_bias=cfg.proj_bias, mlp_bias=cfg.mlp_bias,
                      norm_bias=cfg.norm_bias, gated_mlp=cfg.gated_mlp,
                      qk_norm=cfg.qk_norm, act=act)
        dpr_enc = np.linspace(0, cfg.drop_path_rate_encoder, cfg.encoder_depth).tolist()
        dpr_dec = np.linspace(0, cfg.drop_path_rate_decoder, cfg.decoder_depth).tolist()
        self.encoder = nn.ModuleList([Block(cfg.dim, cfg.num_heads, drop_path=dpr_enc[i],
                                            **common) for i in range(cfg.encoder_depth)])
        self.encoder_norm = LayerNorm(cfg.dim, bias=cfg.norm_bias)
        self.decoder = nn.ModuleList([DecoderBlock(cfg.dim, cfg.num_heads,
                                                   drop_path=dpr_dec[i], **common)
                                      for i in range(cfg.decoder_depth)])
        self.decoder_norm = LayerNorm(cfg.dim, bias=cfg.norm_bias)
        self.decoder_proj_context = Linear(cfg.dim, cfg.dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        if cfg.num_register_tokens > 0:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, cfg.num_register_tokens, cfg.dim))

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
            if leaf in ("mod_emb", "mask_token", "register_tokens") or \
                    name.endswith("token_emb.weight"):
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
        R = self.config.num_register_tokens
        if R > 0:  # live tokens ahead of the sequence, with no position or modality
            B = tokens_k.shape[0]
            reg = self.register_tokens.to(tokens_k.dtype).expand(B, R, -1)
            tokens_k = torch.cat([reg, tokens_k], dim=1)
            emb_k = torch.cat([torch.zeros_like(reg), emb_k], dim=1)
            mask_k = torch.cat([mask_k.new_zeros(B, R), mask_k], dim=1)
            mod_k = torch.cat([mod_k.new_full((B, R), -1), mod_k], dim=1)
        return tokens_k, emb_k, mask_k[:, None, :], mod_k

    # ------------------------------------------------------- decoder masking
    def embed_decoder(self, mod_dict, compute_dtype=None) -> List[Dict[str, Any]]:
        """Per-modality decoder inputs and targets, in sorted modality order:
        dicts with mod / x / emb / ids / mask / attn.  Image-type decoder
        inputs are the mask token; a sequence predicts its next token: its
        own tokens shifted right are the inputs, shifted left the targets,
        and a slot is a target where it and its successor both are
        (reference: egom2p_model.py:285-342)."""
        compute_dtype = compute_dtype or self.compute_dtype
        out = []
        for mod in sorted(self.out_domains):
            if mod not in mod_dict:
                continue
            d = mod_dict[mod]
            x, emb, ids = self.decoder_embeddings[mod].forward_embed(d, compute_dtype)
            tm, attn = d["target_mask"].bool(), d["decoder_attention_mask"].int()
            if self.mod_info[mod]["type"] in SEQ_TYPES:
                out.append(dict(mod=mod, x=x[:, :-1], emb=emb[:, :-1], ids=ids[:, 1:],
                                mask=tm[:, 1:] | tm[:, :-1], attn=attn[:, :-1]))
            else:
                out.append(dict(mod=mod, x=self.mask_token.to(x.dtype).expand(x.shape),
                                emb=emb, ids=ids, mask=tm, attn=attn))
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
        attn = torch.cat([e["attn"] for e in dec_embeds], dim=1)
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
        ids_k, attn_k, mod_k = take(ids), take(attn), take(mod_ids)
        tokens_k = tokens_k.masked_fill(mask_k[..., None], 0.0)
        emb_k = emb_k.masked_fill(mask_k[..., None], 0.0)
        ids_k = ids_k.masked_fill(mask_k, 0)
        mod_k = mod_k.masked_fill(mask_k, -1)
        cfg = self.config
        all_img = all(info[e["mod"]]["type"] not in SEQ_TYPES for e in dec_embeds)
        if all_img and cfg.decoder_sep_mask and not cfg.decoder_causal_mask:
            # for image-type modalities the cumsum + separation mask reduces
            # exactly to "attend within your own modality"
            sa_mask = SegmentMask(segments=mod_k)
        else:
            sa_mask = self.adapt_decoder_attention_mask(attn_k, mod_k)
        return tokens_k, emb_k, mask_k[:, None, :], ids_k, sa_mask, mod_k

    def adapt_decoder_attention_mask(self, attn_compressed: torch.Tensor,
                                     mod_ids: torch.Tensor) -> torch.Tensor:
        """The cumsum-compressed encoding (B, M) -> the (B, M, M) boolean
        self-attention mask, True = blocked: query i sees the keys before
        the running sum at i (or, with `decoder_causal_mask`, the keys up to
        i), and with `decoder_sep_mask` only its own modality's
        (reference: egom2p_model.py:446-481)."""
        B, M = attn_compressed.shape
        device = attn_compressed.device
        if self.config.decoder_causal_mask:
            blocked = torch.ones(M, M, dtype=torch.bool, device=device).triu(1)
            blocked = blocked[None].expand(B, M, M)
        else:
            cums = torch.cumsum(attn_compressed, dim=-1)
            blocked = torch.arange(M, device=device)[None, None, :] >= cums[:, :, None]
        if self.config.decoder_sep_mask:
            blocked = blocked | (mod_ids[:, None, :] != mod_ids[:, :, None])
        return blocked

    # ------------------------------------------------------------- backbones
    def _keep_masks(self, blk, branches: int, B: int, generator, device,
                    rows: Optional[Tuple[int, int]] = None):
        """A block's stochastic-depth masks (branches, B) in training, drawn
        on the CPU from `generator` (the default generator when None), or
        None (eval, or a rate of 0).  With `rows` = (first, total) the batch
        is rows [first, first + B) of a batch of `total` rows: the masks
        are drawn for all of them and this batch's rows taken."""
        if not self.training or blk.drop_path == 0.0:
            return None
        first, total = rows if rows is not None else (0, B)
        keep = torch.full((branches, total), 1.0 - blk.drop_path)
        return torch.bernoulli(keep, generator=generator)[:, first:first + B].to(device)

    def _run_block(self, blk, *args):
        """A block, under activation checkpointing where the config asks for
        it and a backward will follow."""
        cfg = self.config
        if not (cfg.use_act_checkpoint and torch.is_grad_enabled()):
            return blk(*args)
        kw = {}
        if cfg.remat_policy == "dots":
            from torch.utils.checkpoint import create_selective_checkpoint_contexts
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _dots_policy)
        # the block draws no random numbers (its masks come in `args`)
        return checkpoint(blk, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    def forward_encoder(self, x, encoder_mask, generator: Optional[torch.Generator] = None,
                        rows: Optional[Tuple[int, int]] = None):
        for blk in self.encoder:
            keep = self._keep_masks(blk, 2, x.shape[0], generator, x.device, rows)
            x = self._run_block(blk, x, encoder_mask, keep)
        return self.encoder_norm(x)

    def forward_decoder(self, y, context, encoder_mask, sa_mask=None,
                        generator: Optional[torch.Generator] = None,
                        rows: Optional[Tuple[int, int]] = None):
        for blk in self.decoder:
            keep = self._keep_masks(blk, 3, y.shape[0], generator, y.device, rows)
            y = self._run_block(blk, y, context, sa_mask, encoder_mask, keep)
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
            return flash_ce_total(yf, emb_mod.logits_weight, t, w, chunk=chunk), w.sum()
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
                     present_mods: List[str], count_reduce: Optional[Callable] = None):
        """'mod' / 'weighted_mod' / 'token' losses
        (reference: egom2p_model.py:553-680).

        `count_reduce` takes the (len(present_mods),) fp32 target counts and
        returns them summed over the global batch (the process group's
        all-reduce); each modality's loss is then this batch's CE total over
        the global count, this rank's share of the global batch's loss, and
        the shares sum to it over the ranks.  None: the batch is the global
        batch."""
        info = self.mod_info
        totals: Dict[str, torch.Tensor] = {}
        mod_count: Dict[str, torch.Tensor] = {}
        for mod in present_mods:
            w = decoder_mod_mask == info[mod]["id"]
            totals[mod], mod_count[mod] = self._chunked_masked_ce(y, mod, target_ids, w)
        if count_reduce is not None:
            reduced = count_reduce(torch.stack([mod_count[m].float() for m in present_mods]))
            mod_count = dict(zip(present_mods, reduced.unbind(0)))
        mod_loss: Dict[str, torch.Tensor] = {}
        for mod in present_mods:
            total, count = totals[mod], mod_count[mod]
            loss_m = torch.where(count > 0, total / count.clamp(min=1.0),
                                 torch.zeros_like(total))
            if loss_type == "weighted_mod":
                # rescale as if every modality had a 256-entry codebook
                # (reference: egom2p_model.py:608)
                loss_m = loss_m / math.log(info[mod]["vocab_size"]) * math.log(256.0)
            mod_loss[mod] = loss_m

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
                compute_dtype=None, count_reduce: Optional[Callable] = None,
                rows: Optional[Tuple[int, int]] = None):
        """Training forward (reference: egom2p_model.py:683-734): returns
        (loss, {mod: loss}).  The decoder's modality order is a permutation
        drawn from the CPU generator `shuffle`, or sorted order; in training
        mode the stochastic-depth masks are drawn from it after the
        permutation.

        Data parallelism: `mod_dict` is rows [first, first + B) of a global
        batch of `total` rows, `rows` = (first, total), whose random draws
        every rank makes alike and takes its rows of; `count_reduce` sums
        the target counts over the global batch (forward_loss)."""
        compute_dtype = compute_dtype or self.compute_dtype
        enc_embeds = self.embed_encoder(mod_dict, compute_dtype)
        encoder_tokens, encoder_emb, encoder_mask, _ = self.forward_mask_encoder(
            enc_embeds, num_encoder_tokens)

        dec_embeds = self.embed_decoder(mod_dict, compute_dtype)
        perm = None if shuffle is None else torch.randperm(len(dec_embeds), generator=shuffle)
        decoder_tokens, decoder_emb, _, target_ids, sa_mask, dec_mod_mask = \
            self.forward_mask_decoder(dec_embeds, num_decoder_tokens, perm)

        x = self.forward_encoder(encoder_tokens + encoder_emb, encoder_mask, shuffle, rows)
        context = self.decoder_proj_context(x) + encoder_emb
        y = self.forward_decoder(decoder_tokens + decoder_emb, context, encoder_mask, sa_mask,
                                 shuffle, rows)
        return self.forward_loss(y, target_ids, dec_mod_mask, loss_type,
                                 [e["mod"] for e in dec_embeds], count_reduce)

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

    def forward_dec_subset_logits(self, mod_dict, target_mod: str, context, encoder_mask,
                                  ids_keep: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        """The decoder subset pass with the vocab head: fp32 logits (B, k, V)
        at once (egom2p_tpu/models/egom2p.py:forward_dec_subset_logits; the
        sampler takes the hidden states and applies the head by chunks)."""
        y = self.forward_dec_subset_hidden(mod_dict, target_mod, context, encoder_mask,
                                           ids_keep, compute_dtype)
        return self.forward_mod_logits(target_mod, y)

    def forward_mod_logits(self, target_mod: str, y, head_weight=None) -> torch.Tensor:
        """fp32 vocab-head logits of one modality over decoder hidden states;
        the sampler applies it to position chunks."""
        return self.decoder_embeddings[target_mod].forward_logits(y, head_weight)

    def forward_dec_autoregressive_hidden(self, target_mod: str, out_ids: torch.Tensor,
                                          pos_emb: torch.Tensor, context, encoder_mask,
                                          compute_dtype=None) -> torch.Tensor:
        """One full re-forward of the decoder over a sequence target's
        output slots `out_ids` (B, S) (tokens written so far, the rest
        anything: the causal mask hides them from earlier slots), each slot's
        token embedding plus `pos_emb` (B, S, D), under a (1, S, S) causal
        self-attention mask; returns the hidden states (B, S, D)
        (reference: generate.py:892-903)."""
        compute_dtype = compute_dtype or self.compute_dtype
        S = out_ids.shape[1]
        y = self.decoder_embeddings[target_mod].token_emb(out_ids.long()).to(compute_dtype)
        y = y + pos_emb[:, :S]
        causal = torch.ones(S, S, dtype=torch.bool, device=y.device).triu(1)[None]
        return self.forward_decoder(y, context, encoder_mask, causal)

    def forward_dec_autoregressive_logits(self, target_mod: str, out_ids, pos_emb, context,
                                          encoder_mask, compute_dtype=None) -> torch.Tensor:
        """fp32 logits (B, S, V) of every output slot of the re-forward
        above (egom2p_tpu/models/egom2p.py:forward_dec_autoregressive_logits)."""
        y = self.forward_dec_autoregressive_hidden(target_mod, out_ids, pos_emb, context,
                                                   encoder_mask, compute_dtype)
        return self.forward_mod_logits(target_mod, y)


# ----------------------------------------------------------------- registry
def _cfg(depth, dim, heads, **kw):
    return dict(encoder_depth=depth, decoder_depth=depth, dim=dim, num_heads=heads, **kw)


_GELU = dict(mlp_ratio=4.0, qkv_bias=True, act="gelu")
_SWIGLU = dict(mlp_ratio=4.0, qkv_bias=False, proj_bias=False, mlp_bias=False,
               norm_bias=False, act="silu", gated_mlp=True)

# (reference: egom2p_model.py:882-1196)
MODEL_REGISTRY: Dict[str, Dict[str, Any]] = {
    "egom2p_tiny_6e_6d_gelu": _cfg(6, 384, 6, **_GELU),
    "egom2p_small_8e_8d_gelu": _cfg(8, 512, 8, **_GELU),
    "egom2p_base_12e_12d_gelu": _cfg(12, 768, 12, **_GELU),
    "egom2p_large_24e_24d_gelu": _cfg(24, 1024, 16, **_GELU),
    "egom2p_xlarge_24e_24d_gelu": _cfg(24, 2048, 32, **_GELU),
    "egom2p_tiny_6e_6d_swiglu_nobias": _cfg(6, 384, 6, **_SWIGLU),
    "egom2p_small_8e_8d_swiglu_nobias": _cfg(8, 512, 8, **_SWIGLU),
    "egom2p_base_12e_12d_swiglu_nobias": _cfg(12, 768, 12, **_SWIGLU),
    "egom2p_base_12e_12d_swiglu_nobias_causal": _cfg(
        12, 768, 12, decoder_causal_mask=True, **_SWIGLU),
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
