"""Generation sampler: ROAR / MaskGIT over image-type targets, with CFG.

Port of the image-target path of egom2p_tpu/generate/sampler.py (reference:
egom2p/models/generate.py:323-1097).  The host chooses the positions of each
step with numpy (`np.random.default_rng(seed + step)`, the same draw as the
JAX sampler, so both packages pick the same `ids_keep`); the chain state
(tensor / input_mask / target_mask per modality) stays on the device between
steps, and each step is one fused device function: the encoder on the cond
and uncond branches at their own bucketed lengths, the decoder over the k
chosen positions, the CFG mix, the chunked 64k head, top-p sampling and the
scatter update.

Randomness comes from an explicit `torch.Generator` seeded with `seed`.  Its
draws differ from jax.random's: compare greedy tokens, candidate sets and
probabilities across the packages, never sampled tokens.  Top-K is exact
`torch.topk` over the 128-candidate set (the JAX side's EGOM2P_EXACT_TOPK=1).

Not ported yet: sequence targets (the autoregressive path), CFG with
sequence-type conditioning, multi-guided generation and SAM.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from egom2p_torch.data.modality_info import MODALITY_INFO
from egom2p_torch.ops.attention import inference_attention

IMG_TYPES = ("img", "cam", "gaze", "keypoints")

# Candidate set cap for nucleus sampling (egom2p_tpu sampler's _TOPP_TRUNC).
TOPP_TRUNC = 128
# Positions per vocab-head chunk: bounds the live fp32 logits to
# (rows, HEAD_CHUNK, V), 0.5 GB at B = 8 and V = 64000
HEAD_CHUNK = 256


# --------------------------------------------------------------- init helpers
def init_empty_target_modality(mod_dict, modality_info, domain, batch_size,
                               num_tokens):
    """An image-type target with every position still to predict
    (reference: generate.py:30-37, 83-115)."""
    if modality_info[domain]["type"] not in IMG_TYPES:
        raise NotImplementedError(
            f"{domain}: sequence targets wait for the autoregressive port")
    mod_dict[domain] = {
        "tensor": np.zeros((batch_size, num_tokens), dtype=np.int32),
        "input_mask": np.ones((batch_size, num_tokens), dtype=bool),
        "target_mask": np.zeros((batch_size, num_tokens), dtype=bool),
        "decoder_attention_mask": np.zeros((batch_size, num_tokens), dtype=np.int32),
    }
    return mod_dict


def init_full_input_modality(mod_dict, modality_info, domain):
    """An image-type conditioning modality, fully visible
    (reference: generate.py:117-152)."""
    if modality_info[domain]["type"] not in IMG_TYPES:
        raise NotImplementedError(
            f"{domain}: sequence conditioning waits for the autoregressive port")
    d = mod_dict[domain]
    shape = tuple(d["tensor"].shape)
    d["input_mask"] = np.zeros(shape, dtype=bool)
    d["target_mask"] = np.ones(shape, dtype=bool)
    d.setdefault("decoder_attention_mask", np.zeros(shape, dtype=np.int32))
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
        logits = vals / temperature
        choice = torch.argmax(logits + _gumbel(logits.shape, generator, logits.device),
                              dim=-1, keepdim=True)
        sampled = torch.gather(torch.softmax(logits, dim=-1), -1, choice)[..., 0]
        return choice[..., 0].to(torch.int32), sampled
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
            ctx_c, mask_c = model.forward_enc_context(dev, num_enc_c)
            ctx_u, mask_u = model.forward_enc_context(un_view, num_enc_u)
            y_c = model.forward_dec_subset_hidden(dev, target_mod, ctx_c, mask_c, ids_keep)
            y_u = model.forward_dec_subset_hidden(dev, target_mod, ctx_u, mask_u, ids_keep)
            y = torch.cat([y_c, y_u], dim=0)
        else:
            context, enc_mask = model.forward_enc_context(dev, num_enc_c)
            y = model.forward_dec_subset_hidden(dev, target_mod, context, enc_mask, ids_keep)
        samples, probs = chunked_head_sample(
            model, target_mod, y, (cfg_scale,) if use_cfg else None, generator,
            temperature, top_k, top_p, self.info[target_mod]["vocab_size"])
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

    def _img_step(self, mod_dict, dev, dirty: set, target_mod: str,
                  scheme: str, num_select: int, temperature: float,
                  top_k: float, top_p: float, conditioning: List[str],
                  cfg_scale: float, rng: np.random.Generator,
                  generator: torch.Generator) -> None:
        """One ROAR or MaskGIT step.  The host masks in `mod_dict` mirror
        the device state exactly; target_mask False marks a position still
        to predict (reference: generate.py:30-37)."""
        d = mod_dict[target_mod]
        open_mask = ~d["target_mask"]
        # row 0 sets the shared per-step k, like the reference's schedule
        n_remaining = int(open_mask[0].sum())
        if n_remaining == 0:
            return
        use_cfg = cfg_scale != 1.0 and len(conditioning) > 0
        if use_cfg and any(self.info[m]["type"] not in IMG_TYPES for m in conditioning):
            raise NotImplementedError(
                "CFG with sequence-type conditioning waits for the autoregressive port")
        if scheme == "roar":
            k = min(num_select, n_remaining)
            ids_keep = self._select_positions(~open_mask, k, rng, random_order=True)
        elif scheme == "maskgit":  # logits over every open position
            k = n_remaining
            ids_keep = self._select_positions(~open_mask, k, rng, random_order=False)
        else:
            raise ValueError(f"unknown scheme {scheme!r}")

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

    # ------------------------------------------------------------ public API
    @torch.inference_mode()
    def generate(self, mod_dict, schedule, top_k: float = 0.0,
                 top_p: float = 0.0, seed: Optional[int] = None):
        """Run `schedule` (generate/schedules.py) over image-type targets
        (reference: generate.py:1030-1097).  `mod_dict` holds numpy arrays;
        a "tensor" may be a torch tensor already on the device (it stays
        there).  Returns an updated copy with host numpy masks and the
        generated tensors as numpy."""
        mod_dict = {m: {k: (v if k == "tensor" and isinstance(v, torch.Tensor)
                            else _to_numpy(v))
                        for k, v in d.items()}
                    for m, d in mod_dict.items()}
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed if seed is not None else 0)
        dev = None
        dirty: set = set()
        with inference_attention():
            for step, s in enumerate(schedule):
                target_mod = s["target_domain"]
                if self.info[target_mod]["type"] not in IMG_TYPES:
                    raise NotImplementedError(
                        f"{target_mod}: sequence targets wait for the autoregressive port")
                rng = np.random.default_rng((seed + step) if seed is not None else step)
                if dev is None:
                    dev = self._to_device(mod_dict)
                self._img_step(mod_dict, dev, dirty, target_mod, s["scheme"],
                               s["num_tokens"], s["temperature"], top_k, top_p,
                               s.get("cfg_cond_domains", []), s.get("cfg_scale", 1.0),
                               rng, generator)
        for mod in sorted(dirty):
            mod_dict[mod]["tensor"] = dev[mod]["tensor"].cpu().numpy()
        return mod_dict
