"""Generation sampler: ROAR / MaskGIT over image-type targets and
autoregressive decoding of sequence targets (captions), with CFG.

Port of egom2p_tpu/generate/sampler.py (reference:
egom2p/models/generate.py:323-1097).  The host chooses the positions of each
step with numpy (`np.random.default_rng(seed + step)`, the same draw as the
JAX sampler, so both packages pick the same `ids_keep`); the chain state
(tensor / input_mask / target_mask per modality) stays on the device between
steps, and each step is one fused device function: the encoder on the cond
and uncond branches at their own bucketed lengths, the decoder over the k
chosen positions, the CFG mix, the chunked 64k head, top-p sampling and the
scatter update (under a profiler, the spans `egom2p.roar.encoder`,
`.decoder`, `.head` and `.update` of core/tracing.py).  Under CFG with
sequence-type conditioning (a caption) the step stacks cond and uncond into
one 2B-row batch on the host instead, as the JAX sampler does: emptying a
caption rewrites its sentinels.

A sequence target is decoded token by token (`_seq_step`): the encoder runs
once over the (stacked) branches at the bucketed length, then every token
re-runs the decoder over all S output slots at a fixed shape under a causal
mask (no KV cache, as in the JAX package), the head is applied to the slot
being sampled, CFG mixes the fp32 logits l_u + (l_c - l_u) * s, and the loop
stops when every row holds the final sentinel.  The tokens are written back
raw, or merged into the input's sentinel spans through a `text_tokenizer`.

Randomness comes from an explicit `torch.Generator` seeded with `seed`.  Its
draws differ from jax.random's: compare greedy tokens, candidate sets and
probabilities across the packages, never sampled tokens.  Top-K is exact
`torch.topk` over the 128-candidate set (the JAX side's EGOM2P_EXACT_TOPK=1).

`generate_multi_guided` is weighted multi-condition guidance,
l_u + sum_i w_i (l_c_i - l_u), with each finished target joining the
conditions; its step stacks [cond_1, ..., cond_n, uncond] into one
(n + 1) B-row batch through the encoder and decoder and mixes them in
chunked_head_sample.  `generate_sam_dense` runs a sequence target's
generation batch_size times over one shared conditioning and concatenates
the merged spans into one long sequence.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from egom2p_torch.core import tracing
from egom2p_torch.data.modality_info import MODALITY_INFO
from egom2p_torch.data.span import get_sentinel_to_id_mapping, merge_span_masking
from egom2p_torch.ops.attention import inference_attention

IMG_TYPES = ("img", "cam", "gaze", "keypoints")
SEQ_TYPES = ("seq", "seq_emb", "seq_token")

# Candidate set cap for nucleus sampling (egom2p_tpu sampler's _TOPP_TRUNC).
TOPP_TRUNC = 128
# Positions per vocab-head chunk: bounds the live fp32 logits to
# (rows, HEAD_CHUNK, V), 0.5 GB at B = 8 and V = 64000
HEAD_CHUNK = 256


# --------------------------------------------------------------- init helpers
def empty_img_modality(d):
    """Every position hidden from the encoder and still to predict
    (reference: generate.py:30-37)."""
    d["input_mask"][:] = True
    d["target_mask"][:] = False
    return d


def empty_seq_modality(d, s1_id: int = 5):
    """An empty sequence: the input is the one sentinel [S_1] (id `s1_id`)
    in slot 0, and every other slot is a target, slot 1 starting with
    [S_1] and the last slot holding [S_2] (reference: generate.py:39-63)."""
    d["tensor"][:] = 0
    d["tensor"][:, [0, 1]] = s1_id
    d["tensor"][:, -1] = s1_id + 1
    d["input_mask"][:] = True
    d["input_mask"][:, 0] = False
    d["target_mask"] = ~d["input_mask"]
    d["decoder_attention_mask"][:] = 1
    d["decoder_attention_mask"][:, 0] = 0
    return d


def empty_seq_emb_modality(d):
    """Empty T5 / CLIP-embedding conditioning: zero embeddings with one live
    slot, so the uncond branch still holds a conditioning token
    (reference: generate.py:65-80)."""
    d["tensor"][:] = 0
    d["input_mask"][:] = True
    d["input_mask"][:, 0] = False
    d["target_mask"][:] = True
    d["decoder_attention_mask"][:] = 0
    return d


def init_empty_target_modality(mod_dict, modality_info, domain, batch_size,
                               num_tokens):
    """A target with every position still to predict: an image type, or a
    sequence (at least 2 slots; a `seq_emb` one holds zero float
    embeddings (B, N, orig_emb_dim)) (reference: generate.py:83-115)."""
    mtype = modality_info[domain]["type"]
    if mtype in IMG_TYPES:
        shape, tensor = (batch_size, num_tokens), np.zeros((batch_size, num_tokens), np.int32)
        empty = empty_img_modality
    elif mtype in SEQ_TYPES:
        shape = (batch_size, max(num_tokens, 2))
        if mtype == "seq_emb":
            tensor = np.zeros(shape + (modality_info[domain].get("orig_emb_dim", 4096),),
                              dtype=np.float32)
            empty = empty_seq_emb_modality
        else:
            tensor, empty = np.zeros(shape, dtype=np.int32), empty_seq_modality
    else:
        raise ValueError(f"{domain}: modality type {mtype!r}")
    mod_dict[domain] = empty({"tensor": tensor,
                              "input_mask": np.ones(shape, dtype=bool),
                              "target_mask": np.zeros(shape, dtype=bool),
                              "decoder_attention_mask": np.zeros(shape, dtype=np.int32)})
    return mod_dict


def init_full_input_modality(mod_dict, modality_info, domain, eos_id: int = 3):
    """A conditioning modality, fully visible: an image type whole; a
    sequence up to and with its first [EOS] (`eos_id`; a sequence with none
    gets one in slot 0); T5 embeddings where `mask_valid` says
    (reference: generate.py:117-152)."""
    d = mod_dict[domain]
    mtype = modality_info[domain]["type"]
    if mtype == "seq_emb":
        valid = np.asarray(d["mask_valid"], dtype=bool)
        d["input_mask"] = ~valid
        d["target_mask"] = np.ones_like(valid)
        d["decoder_attention_mask"] = np.zeros(valid.shape, dtype=np.int32)
        return mod_dict
    shape = tuple(d["tensor"].shape)
    d.setdefault("input_mask", np.zeros(shape, dtype=bool))
    d.setdefault("target_mask", np.ones(shape, dtype=bool))
    d.setdefault("decoder_attention_mask", np.zeros(shape, dtype=np.int32))
    if mtype in IMG_TYPES:
        d["input_mask"] = np.zeros(shape, dtype=bool)
        d["target_mask"] = np.ones(shape, dtype=bool)
    elif mtype in ("seq", "seq_token"):
        t = d["tensor"]
        if (t == eos_id).any():
            eos_idx = int(np.where(t == eos_id)[1][0])
        else:
            t[:, 0] = eos_id
            eos_idx = 0
        d["input_mask"][:, :eos_idx + 1] = False
        d["input_mask"][:, eos_idx + 1:] = True
        d["target_mask"][:] = True
    return mod_dict


def expand_to_batch(mod_dict, batch_size):
    """Every array of batch 1 repeated to `batch_size` rows, in place
    (reference: generate.py:185-195)."""
    for mod, d in mod_dict.items():
        for k, v in d.items():
            if v.shape[0] == 1:
                d[k] = np.repeat(v, batch_size, axis=0)
            elif v.shape[0] != batch_size:
                raise ValueError(f"bad batch dim for {mod}/{k}")
    return mod_dict


# ------------------------------------------------------------------ sampling
def _candidate_count(V: int, temperature: float, top_k: float, top_p: float):
    """(k_user, K): user top-k and the candidate-set size the sampler uses.
    K == V means no truncation was requested (sample the full vocab)."""
    if abs(temperature) < 1e-10:
        return 0, 1  # greedy: the top-1 candidate is the sample
    k_user = 0
    if top_k and top_k > 0:
        k_user = int(top_k) if top_k >= 1 else max(1, int(top_k * V))
    K = min(V, max(k_user, TOPP_TRUNC) if (top_p and top_p > 0) else
            (k_user or V))
    return k_user, K


def _candidate_logits(vals: torch.Tensor, temperature: float, k_user: int,
                      top_p: float) -> torch.Tensor:
    """Sampling logits over a sorted-descending candidate set: the user
    top-k and the nucleus (top-p) cutoffs set dropped candidates to -inf,
    then divide by the temperature (reference: generate.py:332-382)."""
    if k_user and k_user < vals.shape[-1]:
        pos = torch.arange(vals.shape[-1], device=vals.device)
        vals = vals.masked_fill(pos >= k_user, float("-inf"))
    if top_p and top_p > 0.0:
        cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
        # shift right so the first token above the threshold is kept
        # (reference: generate.py:350-353)
        remove = torch.cat([torch.zeros_like(cum[..., :1], dtype=torch.bool),
                            cum[..., :-1] > top_p], dim=-1)
        vals = vals.masked_fill(remove, float("-inf"))
    return vals / temperature


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sample_from_candidates(vals, idxs, generator, temperature: float,
                            k_user: int, top_p: float):
    """Categorical sample per position over its candidates.

    vals: (..., K) fp32, sorted descending; idxs: the matching token ids.
    Returns (samples int32, probability of each sample)."""
    if abs(temperature) < 1e-10:
        samples = idxs[..., 0].to(torch.int32)
        return samples, torch.ones(samples.shape, device=vals.device)
    logits = _candidate_logits(vals, temperature, k_user, top_p)
    probs = torch.softmax(logits, dim=-1)
    choice = torch.argmax(logits + _gumbel(logits.shape, generator, logits.device),
                          dim=-1, keepdim=True)
    sampled = torch.gather(probs, -1, choice)[..., 0]
    return torch.gather(idxs, -1, choice)[..., 0].to(torch.int32), sampled


def _sample_all(logits: torch.Tensor, generator: torch.Generator, temperature: float):
    """A categorical sample over the whole last axis (no truncation):
    (samples int32, probability of each sample)."""
    scaled = logits / temperature
    choice = torch.argmax(scaled + _gumbel(scaled.shape, generator, scaled.device),
                          dim=-1, keepdim=True)
    sampled = torch.gather(torch.softmax(scaled, dim=-1), -1, choice)[..., 0]
    return choice[..., 0].to(torch.int32), sampled


def sample_tokens(logits: torch.Tensor, generator: torch.Generator, temperature: float,
                  top_k: float, top_p: float):
    """Top-k / top-p filtering and a categorical sample per row of fp32
    logits (..., V) (reference: generate.py:332-382): greedy is the argmax;
    a truncation samples among the top-K candidates, exact torch.topk (the
    JAX side's EGOM2P_EXACT_TOPK=1); none samples the whole vocabulary.
    Returns (samples int32, probability of each sample)."""
    if abs(temperature) < 1e-10:
        samples = logits.argmax(dim=-1).to(torch.int32)
        return samples, torch.ones(samples.shape, device=logits.device)
    V = logits.shape[-1]
    k_user, K = _candidate_count(V, temperature, top_k, top_p)
    if K < V or k_user or (top_p and top_p > 0.0):
        vals, idxs = torch.topk(logits, K, dim=-1)
        return _sample_from_candidates(vals, idxs, generator, temperature, k_user, top_p)
    return _sample_all(logits, generator, temperature)


def chunked_head_sample(model, target_mod: str, y: torch.Tensor, cond_weights,
                        generator: torch.Generator, temperature: float,
                        top_k: float, top_p: float, vocab_size: int):
    """Vocab head + guidance mix + sampling over position chunks.

    `y`: (G*B, k, dim) decoder hidden states of G stacked guidance branches
    [cond_1, ..., cond_n, uncond] (G = 1 when `cond_weights` is None).  The
    mix is l_u + sum_i w_i (l_c_i - l_u) (reference: generate.py:805,
    719-721).  By default it is applied to the hidden states before the head
    (logits are linear in y, so this is the same mix at the head's compute
    precision, for B rows instead of G*B); EGOM2P_CFG_MIX=logits mixes the
    fp32 logits instead.  Chunking bounds the live fp32 logits to
    (rows, chunk, V), each chunk reduced to its top-K candidates at once.

    Returns (samples (B, k) int32, sampled probabilities (B, k) fp32)."""
    GB, k, _ = y.shape
    G = 1 if cond_weights is None else len(cond_weights) + 1
    B = GB // G
    if cond_weights is not None and os.environ.get("EGOM2P_CFG_MIX", "hidden") != "logits":
        yu = y[(G - 1) * B:]
        mixed = yu
        for i, w in enumerate(cond_weights):
            mixed = mixed + w * (y[i * B:(i + 1) * B] - yu)
        y, cond_weights, G = mixed, None, 1
    k_user, K = _candidate_count(vocab_size, temperature, top_k, top_p)
    greedy = abs(temperature) < 1e-10
    untruncated = K >= vocab_size and not k_user and not (top_p and top_p > 0)

    # balance the chunk size so the last chunk is not mostly empty
    n_chunks = max(1, -(-k // HEAD_CHUNK))
    per_chunk = -(-k // n_chunks)            # ceil
    chunk = max(8, -(-per_chunk // 8) * 8)   # rounded up to a multiple of 8
    head = model.decoder_embeddings[target_mod].head_weight(y.dtype)
    vals_parts, idx_parts = [], []
    for c in range(n_chunks):
        logits = model.forward_mod_logits(target_mod, y[:, c * chunk:(c + 1) * chunk], head)
        if G > 1:
            lu = logits[(G - 1) * B:]
            mixed = lu
            for i, w in enumerate(cond_weights):
                mixed = mixed + w * (logits[i * B:(i + 1) * B] - lu)
        else:
            mixed = logits
        if greedy:
            v, i = mixed.max(dim=-1, keepdim=True)
        elif untruncated:
            v, i = mixed, None  # rare: sample the full vocab
        else:
            v, i = torch.topk(mixed, min(K, vocab_size), dim=-1)
        vals_parts.append(v)
        idx_parts.append(i)
    vals = torch.cat(vals_parts, dim=1)
    if untruncated and not greedy:
        return _sample_all(vals, generator, temperature)
    idxs = torch.cat(idx_parts, dim=1)
    return _sample_from_candidates(vals, idxs, generator, temperature, k_user, top_p)


def _bucket(n: int, size: int = 256) -> int:
    return max(size, ((n + size - 1) // size) * size)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.array(v)


class GenerationSampler:
    """Wraps an EgoM2P module (weights on its device) for generation."""

    def __init__(self, model, modality_info=None):
        self.model = model
        self.info = modality_info or model.mod_info or MODALITY_INFO

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ------------------------------------------------------------ host utils
    def _num_enc_tokens(self, mod_dict, exclude: tuple = ()) -> int:
        """Max unmasked count over the batch, summed over the encoder's
        modalities (reference: generate.py:415); `exclude` counts a CFG
        uncond view (emptied conditioning) without building it."""
        total = 0
        for mod in mod_dict:
            if mod in self.model.in_domains and mod not in exclude:
                total += int((~mod_dict[mod]["input_mask"]).sum(axis=1).max())
        return total

    def _select_positions(self, target_mask: np.ndarray, k: int,
                          rng: np.random.Generator, random_order: bool):
        """k still-to-predict positions per row: ROAR uses a random
        tiebreak, MaskGIT a deterministic one (reference: generate.py:447-516)."""
        B, L = target_mask.shape
        if random_order:
            tie = rng.random(L)[None, :] * 1e-6
        else:
            tie = np.arange(L, dtype=np.float64)[None, :] * 1e-6
        order = np.argsort(target_mask.astype(np.float64) + tie, axis=1)
        return order[:, :k].astype(np.int32)

    def _to_device(self, mod_dict) -> Dict[str, Dict[str, torch.Tensor]]:
        """Device copies of the chain state; tensors the caller passed are
        cloned, since the steps update the copies in place."""
        return {mod: {k: (v.to(self.device, copy=True) if isinstance(v, torch.Tensor)
                          else torch.from_numpy(np.array(v)).to(self.device))
                      for k, v in d.items()}
                for mod, d in mod_dict.items()}

    def _make_uncond(self, mod_dict, conditioning: List[str]):
        """The CFG uncond branch on the host: every conditioning modality
        emptied (reference: generate.py:792-800)."""
        un = copy.deepcopy(mod_dict)
        for mod in conditioning:
            mtype = self.info[mod]["type"]
            if mtype in ("seq", "seq_token"):
                empty_seq_modality(un[mod])
            elif mtype == "seq_emb":
                empty_seq_emb_modality(un[mod])
            else:
                empty_img_modality(un[mod])
        return un

    @staticmethod
    def _stack_dicts(a, b):
        return {mod: {k: np.concatenate([a[mod][k], b[mod][k]], axis=0) for k in a[mod]}
                for mod in a}

    # ------------------------------------------------------------- gen steps
    def _fused_img_step(self, dev, target_mod: str, num_enc_c: int,
                        num_enc_u: int, ids_keep: torch.Tensor, num_select: int,
                        use_cfg: bool, cfg_scale: float, temperature: float,
                        top_k: float, top_p: float, cond_mods: tuple,
                        generator: torch.Generator) -> torch.Tensor:
        """One ROAR / MaskGIT step on the device: encoder (split-shape CFG)
        + decoder over `ids_keep` + CFG mix + sampling + confidence selection
        + scatter update of `dev[target_mod]` in place.  Returns the filled
        positions (B, num_select)."""
        model = self.model
        if use_cfg:
            un_view = {mod: ({**d, "input_mask": torch.ones_like(d["input_mask"])}
                             if mod in cond_mods else d)
                       for mod, d in dev.items()}
            # split-shape CFG: cond and uncond run at their own encoder
            # lengths through the encoder and the decoder cross-attention
            with tracing.span("egom2p.roar.encoder"):
                ctx_c, mask_c = model.forward_enc_context(dev, num_enc_c)
            with tracing.span("egom2p.roar.encoder"):
                ctx_u, mask_u = model.forward_enc_context(un_view, num_enc_u)
            with tracing.span("egom2p.roar.decoder"):
                y_c = model.forward_dec_subset_hidden(dev, target_mod, ctx_c, mask_c, ids_keep)
            with tracing.span("egom2p.roar.decoder"):
                y_u = model.forward_dec_subset_hidden(dev, target_mod, ctx_u, mask_u, ids_keep)
            y = torch.cat([y_c, y_u], dim=0)
        else:
            with tracing.span("egom2p.roar.encoder"):
                context, enc_mask = model.forward_enc_context(dev, num_enc_c)
            with tracing.span("egom2p.roar.decoder"):
                y = model.forward_dec_subset_hidden(dev, target_mod, context, enc_mask, ids_keep)
        with tracing.span("egom2p.roar.head"):
            samples, probs = chunked_head_sample(
                model, target_mod, y, (cfg_scale,) if use_cfg else None, generator,
                temperature, top_k, top_p, self.info[target_mod]["vocab_size"])
        with tracing.span("egom2p.roar.update"):
            if num_select < ids_keep.shape[1]:
                # MaskGIT: keep the most confident positions (reference: generate.py:652-665)
                top_idx = torch.topk(probs, num_select, dim=1).indices
                sel_pos = torch.gather(ids_keep, 1, top_idx)
                samples = torch.gather(samples, 1, top_idx)
            else:
                sel_pos = ids_keep
            d = dev[target_mod]
            rows = torch.arange(sel_pos.shape[0], device=sel_pos.device)[:, None]
            d["tensor"][rows, sel_pos] = samples.to(d["tensor"].dtype)
            d["input_mask"][rows, sel_pos] = False
            d["target_mask"][rows, sel_pos] = True
        return sel_pos

    def _stacked_step(self, mod_dict, target_mod: str, ids_keep: np.ndarray, k: int,
                      num_select: int, scheme: str, cfg_scale: float, temperature: float,
                      top_k: float, top_p: float, conditioning: List[str],
                      generator: torch.Generator) -> None:
        """One ROAR / MaskGIT step under CFG with sequence-type
        conditioning, on host copies: cond and the emptied uncond stacked
        into one 2B-row batch through the encoder (at the stacked bucketed
        length) and the decoder, the CFG mix, sampling, and the update of
        `mod_dict[target_mod]` (egom2p_tpu/generate/sampler.py:_step_fn)."""
        model, d = self.model, mod_dict[target_mod]
        stacked = self._stack_dicts(mod_dict, self._make_uncond(mod_dict, conditioning))
        dev = self._to_device(stacked)
        ids = torch.from_numpy(np.concatenate([ids_keep, ids_keep])).to(self.device, torch.int64)
        with tracing.span("egom2p.roar.encoder"):
            context, enc_mask = model.forward_enc_context(
                dev, _bucket(self._num_enc_tokens(stacked)))
        with tracing.span("egom2p.roar.decoder"):
            y = model.forward_dec_subset_hidden(dev, target_mod, context, enc_mask, ids)
        with tracing.span("egom2p.roar.head"):
            samples, probs = chunked_head_sample(model, target_mod, y, (cfg_scale,), generator,
                                                 temperature, top_k, top_p,
                                                 self.info[target_mod]["vocab_size"])
        with tracing.span("egom2p.roar.update"):
            samples, probs = samples.cpu().numpy(), probs.cpu().numpy()
            if scheme == "maskgit" and num_select < k:
                top_idx = np.argsort(-probs, axis=1)[:, :num_select]
                sel_pos = np.take_along_axis(ids_keep, top_idx, axis=1)
                samples = np.take_along_axis(samples, top_idx, axis=1)
            else:
                sel_pos = ids_keep
            rows = np.arange(sel_pos.shape[0])[:, None]
            d["tensor"][rows, sel_pos] = samples.astype(d["tensor"].dtype)
            d["input_mask"][rows, sel_pos] = False
            d["target_mask"][rows, sel_pos] = True

    def _img_step(self, mod_dict, dev, dirty: set, target_mod: str,
                  scheme: str, num_select: int, temperature: float,
                  top_k: float, top_p: float, conditioning: List[str],
                  cfg_scale: float, rng: np.random.Generator,
                  generator: torch.Generator, to_host) -> None:
        """One ROAR or MaskGIT step.  The host masks in `mod_dict` mirror
        the device state exactly; target_mask False marks a position still
        to predict (reference: generate.py:30-37).  `to_host()` brings the
        device chain state back into `mod_dict`, for the stacked step."""
        d = mod_dict[target_mod]
        open_mask = ~d["target_mask"]
        # row 0 sets the shared per-step k, like the reference's schedule
        n_remaining = int(open_mask[0].sum())
        if n_remaining == 0:
            return
        use_cfg = cfg_scale != 1.0 and len(conditioning) > 0
        if scheme == "roar":
            k = min(num_select, n_remaining)
            ids_keep = self._select_positions(~open_mask, k, rng, random_order=True)
        elif scheme == "maskgit":  # logits over every open position
            k = n_remaining
            ids_keep = self._select_positions(~open_mask, k, rng, random_order=False)
        else:
            raise ValueError(f"unknown scheme {scheme!r}")

        if use_cfg and any(self.info[m]["type"] in SEQ_TYPES for m in conditioning):
            to_host()
            self._stacked_step(mod_dict, target_mod, ids_keep, k, num_select, scheme,
                               cfg_scale, temperature, top_k, top_p, conditioning, generator)
            dev[target_mod] = self._to_device({target_mod: d})[target_mod]
            return
        num_enc_c = _bucket(self._num_enc_tokens(mod_dict))
        num_enc_u = _bucket(self._num_enc_tokens(mod_dict, exclude=tuple(conditioning)),
                            256) if use_cfg else 0
        n_sel = min(num_select if scheme == "maskgit" else k, k)
        sel_pos = self._fused_img_step(
            dev, target_mod, num_enc_c, num_enc_u,
            torch.from_numpy(ids_keep).to(self.device, torch.int64), n_sel,
            use_cfg, cfg_scale, temperature, top_k, top_p,
            tuple(sorted(conditioning)), generator)
        dirty.add(target_mod)
        # host mask mirrors; ROAR fills exactly the chosen ids: no readback
        sel_np = ids_keep if n_sel == k else sel_pos.cpu().numpy()
        rows = np.arange(sel_np.shape[0])[:, None]
        d["input_mask"][rows, sel_np] = False
        d["target_mask"][rows, sel_np] = True

    # ------------------------------------------------------- autoregressive
    def _seq_step(self, mod_dict, target_mod: str, temperature: float, top_k: float,
                  top_p: float, conditioning: List[str], cfg_scale: float,
                  generator: torch.Generator, text_tokenizer=None) -> int:
        """Autoregressive decoding of a sequence target on host copies
        (reference: generate.py:852-1027), with span merging (reference:
        generate.py:552-628) where `text_tokenizer` is given.  Returns the
        number of output slots written (the first is given, so the decoder
        ran one fewer times)."""
        model, d = self.model, mod_dict[target_mod]
        use_cfg = cfg_scale != 1.0 and len(conditioning) > 0
        stacked = (self._stack_dicts(mod_dict, self._make_uncond(mod_dict, conditioning))
                   if use_cfg else mod_dict)
        dev = self._to_device(stacked)
        context, enc_mask = model.forward_enc_context(dev, _bucket(self._num_enc_tokens(stacked)))

        # the target slots in mask order (reference: generate.py:518-550)
        tm = d["target_mask"]
        B = tm.shape[0]
        order = np.argsort(tm.astype(np.float64) + np.arange(tm.shape[1])[None] * 1e-6, axis=1)
        S = min(int((~tm[0]).sum()), self.info[target_mod]["max_tokens"])
        ids_keep = order[:, :S]
        rows = np.arange(B)[:, None]
        dec_ids = d["tensor"][rows, ids_keep]
        reps = 2 if use_cfg else 1
        idx = torch.from_numpy(np.concatenate([ids_keep] * reps)).to(self.device, torch.int64)
        # the slots' positions in bf16 whatever the compute dtype, as the
        # JAX sampler embeds them (its forward_embed's default dtype)
        _, emb, _ = model.decoder_embeddings[target_mod].forward_embed(dev[target_mod],
                                                                       torch.bfloat16)
        y_emb = torch.gather(emb, 1, idx[..., None].expand(-1, -1, emb.shape[-1]))

        eos_token = int(dec_ids[0][-1])  # the final sentinel (generate.py:875)
        out = torch.zeros(reps * B, S, dtype=torch.int64, device=self.device)
        out[:, 0] = torch.from_numpy(np.concatenate([dec_ids[:, 0]] * reps)).to(self.device)
        head = model.decoder_embeddings[target_mod].head_weight(model.compute_dtype)
        n_gen = 1
        for i in range(1, S):
            y = model.forward_dec_autoregressive_hidden(target_mod, out, y_emb, context, enc_mask)
            last = model.forward_mod_logits(target_mod, y[:, i - 1], head)  # (B', V) fp32
            if use_cfg:
                lc, lu = last[:B], last[B:]
                last = lu + (lc - lu) * cfg_scale
            nxt, _ = sample_tokens(last, generator, temperature, top_k, top_p)
            out[:, i] = nxt.long().repeat(reps)
            n_gen = i + 1
            if bool((out[:B, :n_gen] == eos_token).any(dim=-1).all()):
                break
        out = out[:B, :n_gen].cpu().numpy().astype(d["tensor"].dtype)

        if text_tokenizer is None:  # raw tokens into the target slots
            d["tensor"][rows, ids_keep[:, :n_gen]] = out
            d["input_mask"][rows, ids_keep[:, :n_gen]] = False
            d["target_mask"][rows, ids_keep[:, :n_gen]] = True
            return n_gen
        # the predicted spans merged into each row's input
        # (reference: merge_sequences_batched, generate.py:583-628)
        sentinel_ids = set(get_sentinel_to_id_mapping(text_tokenizer).values())
        pad_id = text_tokenizer.token_to_id("[PAD]")
        merged = []
        for b in range(B):
            inp = d["tensor"][b][~d["input_mask"][b]].tolist() or [min(sentinel_ids)]
            merged.append(merge_span_masking(inp, out[b].tolist(), sentinel_ids))
        max_len = max(len(r) for r in merged)
        tensor = np.full((B, max_len), pad_id, dtype=np.int32)
        input_mask = np.ones((B, max_len), dtype=bool)
        for b, r in enumerate(merged):
            tensor[b, :len(r)] = r
            input_mask[b, :len(r)] = False
        mod_dict[target_mod] = {"tensor": tensor, "input_mask": input_mask,
                                "target_mask": np.ones((B, max_len), dtype=bool),
                                "decoder_attention_mask": np.zeros((B, max_len), dtype=np.int32)}
        return n_gen

    # ------------------------------------------------- multi-guided variant
    @torch.inference_mode()
    def generate_multi_guided(self, uncond_dict, cond_dicts, schedule, top_k: float = 0.0,
                              top_p: float = 0.0, seed: Optional[int] = None):
        """Weighted multi-condition generation of image-type targets
        (egom2p_tpu/generate/sampler.py:generate_multi_guided; reference:
        generate.py:1170-1229).  `uncond_dict` holds every modality (the
        conditioning ones emptied); each of `cond_dicts` holds a subset of
        conditioning modalities, and a modality it lacks is taken from
        `uncond_dict` fully masked.  A schedule step's `cfg_scale` is one
        weight for every condition or a list of them; when the target
        changes, the finished one joins as a further condition (weighted as
        the list's last).  Each step stacks [cond_1, ..., cond_n, uncond]
        into one batch: the encoder over (n + 1) B rows at the bucketed
        length, the decoder over the chosen positions, and
        chunked_head_sample's mix l_u + sum_i w_i (l_c_i - l_u).  Positions
        come from np.random.default_rng(seed + step) as in the JAX sampler.
        Returns the updated uncond dict (numpy)."""
        uncond = {m: {k: _to_numpy(v) for k, v in d.items()} for m, d in uncond_dict.items()}
        conds = [{m: {k: _to_numpy(v) for k, v in d.items()} for m, d in c.items()}
                 for c in cond_dicts]
        cur_target = schedule[0]["target_domain"]
        for c in conds:
            c[cur_target] = copy.deepcopy(uncond[cur_target])
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed if seed is not None else 0)
        with inference_attention():
            for step, s in enumerate(schedule):
                target_mod = s["target_domain"]
                if cur_target != target_mod:
                    # the finished modality becomes an extra condition
                    # (reference: generate.py:1192-1210)
                    for c in conds:
                        del c[cur_target]
                        c[target_mod] = copy.deepcopy(uncond[target_mod])
                    uncond[cur_target]["input_mask"][:] = True
                    new_cond = {cur_target: copy.deepcopy(uncond[cur_target]),
                                target_mod: copy.deepcopy(uncond[target_mod])}
                    new_cond[cur_target]["input_mask"][:] = False
                    new_cond[cur_target]["target_mask"][:] = True
                    conds.append(new_cond)
                    cur_target = target_mod
                rng = np.random.default_rng((seed or 0) + step)
                open_mask = ~uncond[target_mod]["target_mask"]
                n_remaining = int(open_mask[0].sum())
                if n_remaining == 0:
                    continue
                k = min(s["num_tokens"], n_remaining)
                ids_keep = self._select_positions(~open_mask, k, rng, s["scheme"] == "roar")
                # [cond_1 .. cond_n, uncond]; a modality a condition lacks is
                # uncond's, fully masked
                stacked = None
                for c in conds + [uncond]:
                    filled = dict(c)
                    for m in uncond:
                        if m not in filled:
                            masked = {kk: np.array(vv) for kk, vv in uncond[m].items()}
                            masked["input_mask"][:] = True
                            filled[m] = masked
                    stacked = filled if stacked is None else self._stack_dicts(stacked, filled)
                weights = list(np.atleast_1d(np.asarray(s["cfg_scale"], dtype=float)))
                if len(weights) == 1:
                    weights = weights * len(conds)
                while len(weights) < len(conds):  # the generated modalities' conditions
                    weights.append(weights[-1])
                dev = self._to_device(stacked)
                ids = torch.from_numpy(np.concatenate([ids_keep] * (len(conds) + 1))).to(
                    self.device, torch.int64)
                context, enc_mask = self.model.forward_enc_context(
                    dev, _bucket(self._num_enc_tokens(stacked)))
                y = self.model.forward_dec_subset_hidden(dev, target_mod, context, enc_mask, ids)
                samples, _ = chunked_head_sample(
                    self.model, target_mod, y, tuple(weights[:len(conds)]), generator,
                    s["temperature"], top_k, top_p, self.info[target_mod]["vocab_size"])
                samples = samples.cpu().numpy()
                rows = np.arange(ids_keep.shape[0])[:, None]
                for dd in [uncond] + conds:
                    t = dd[target_mod]
                    t["tensor"][rows, ids_keep] = samples.astype(t["tensor"].dtype)
                    t["input_mask"][rows, ids_keep] = False
                    t["target_mask"][rows, ids_keep] = True
        return uncond

    def generate_sam_dense(self, mod_dict, schedule, text_tokenizer, batch_size: int = 16,
                           key: str = "sam_instance", top_k: float = 0.0, top_p: float = 0.0,
                           seed: Optional[int] = None):
        """Dense instance prediction: the sequence target `key` generated
        batch_size times over one shared conditioning (the batch-1
        `mod_dict` repeated), each row's output merged into its input's
        sentinel spans, and the merged rows concatenated into one long
        (1, L) sequence (egom2p_tpu/generate/sampler.py:generate_sam_dense;
        reference: generate.py:1231-1274).  Only the schedule's steps of
        `key` run.  Returns a copy of `mod_dict` with `key` replaced."""
        mod_dict = {m: {k: _to_numpy(v) for k, v in d.items()} for m, d in mod_dict.items()}
        expanded = expand_to_batch({m: {k: np.array(v) for k, v in d.items()}
                                    for m, d in mod_dict.items()}, batch_size)
        out = self.generate(expanded, [s for s in schedule if s["target_domain"] == key],
                            top_k=top_k, top_p=top_p, seed=seed, text_tokenizer=text_tokenizer)
        sentinel_ids = set(get_sentinel_to_id_mapping(text_tokenizer).values())
        row, merged = out[key], []
        for i in range(batch_size):
            inp = row["tensor"][i][~row["input_mask"][i]].tolist()
            tgt = row["tensor"][i][~row["target_mask"][i]].tolist()
            merged.extend(merge_span_masking(inp, tgt, sentinel_ids))
        merged_arr = np.asarray(merged, dtype=np.int32)[None]
        mod_dict[key] = {"tensor": merged_arr,
                         "input_mask": np.zeros(merged_arr.shape, dtype=bool),
                         "target_mask": np.ones(merged_arr.shape, dtype=bool),
                         "decoder_attention_mask": np.zeros(merged_arr.shape, dtype=np.int32)}
        return mod_dict

    # ------------------------------------------------------------ public API
    def generate_iter(self, mod_dict, schedule, top_k: float = 0.0, top_p: float = 0.0,
                      text_tokenizer=None, seed: Optional[int] = None):
        """`generate` one schedule step at a time, yielding the state after
        each (step i seeded seed + i) (reference: generate.py:1100-1168)."""
        for step, s in enumerate(schedule):
            mod_dict = self.generate(mod_dict, [s], top_k=top_k, top_p=top_p,
                                     text_tokenizer=text_tokenizer, seed=(seed or 0) + step)
            yield mod_dict

    @torch.inference_mode()
    def generate(self, mod_dict, schedule, top_k: float = 0.0,
                 top_p: float = 0.0, seed: Optional[int] = None, text_tokenizer=None):
        """Run `schedule` (generate/schedules.py) (reference:
        generate.py:1030-1097).  `mod_dict` holds numpy arrays; a "tensor"
        may be a torch tensor already on the device (it stays there until a
        host-side step needs it).  Returns an updated copy with host numpy
        masks and the generated tensors as numpy; a sequence target merged
        through `text_tokenizer` takes its merged length."""
        mod_dict = {m: {k: (v if k == "tensor" and isinstance(v, torch.Tensor)
                            else _to_numpy(v))
                        for k, v in d.items()}
                    for m, d in mod_dict.items()}
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed if seed is not None else 0)
        dev = None
        dirty: set = set()

        def to_host():
            """The device state's changed tensors, and every device tensor
            the caller passed, as numpy in `mod_dict`."""
            for mod in sorted(dirty):
                mod_dict[mod]["tensor"] = dev[mod]["tensor"].cpu().numpy()
            dirty.clear()
            for d in mod_dict.values():
                if isinstance(d["tensor"], torch.Tensor):
                    d["tensor"] = d["tensor"].cpu().numpy()

        with inference_attention():
            for step, s in enumerate(schedule):
                target_mod = s["target_domain"]
                rng = np.random.default_rng((seed + step) if seed is not None else step)
                conditioning, cfg_scale = s.get("cfg_cond_domains", []), s.get("cfg_scale", 1.0)
                mtype = self.info[target_mod]["type"]
                if mtype in IMG_TYPES:
                    if dev is None:
                        dev = self._to_device(mod_dict)
                    self._img_step(mod_dict, dev, dirty, target_mod, s["scheme"],
                                   s["num_tokens"], s["temperature"], top_k, top_p,
                                   conditioning, cfg_scale, rng, generator, to_host)
                elif mtype in SEQ_TYPES:
                    if dev is not None or any(isinstance(d["tensor"], torch.Tensor)
                                              for d in mod_dict.values()):
                        to_host()
                    dev = None  # a merge may change the shapes: uploaded again at need
                    self._seq_step(mod_dict, target_mod, s["temperature"], top_k, top_p,
                                   conditioning, cfg_scale, generator, text_tokenizer)
                else:
                    raise ValueError(f"invalid schedule target {target_mod}")
        if dev is not None:
            for mod in sorted(dirty):
                mod_dict[mod]["tensor"] = dev[mod]["tensor"].cpu().numpy()
        return mod_dict
