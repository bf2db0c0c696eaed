"""Unified Dirichlet-budget masking, the pretraining objective.

Numpy port of egom2p_tpu/masking/unified.py:UnifiedMasking (reference:
egom2p/data/masking.py:131-564): per sample, input and target token budgets
per modality from a mixture of Dirichlet distributions (clamp and retry to
respect the min/max token counts), then per modality
  * image types (img, cam, gaze, keypoints): a random-permutation keep-k
    with the cumsum-compressed decoder attention encoding;
  * `seq` (text through a WordPiece tokenizer; a list of strings is masked
    chunk by chunk), `seq_token` (pre-tokenized ids shifted by
    `vocab_offset`) and `seq_emb` (precomputed embeddings, input only):
    sentinel span masking (data/span.py) whose keep probability decays
    until the input fits its budget, packed into (max_tokens + 1) * 2
    slots (max_tokens for seq_emb) with the target at the input budget.
The random draws come in the JAX package's order, so one seed gives the
same masks in both.  Without `sampling_weights` the mixture component is a
uniform draw; without a target budget (`target_tokens_range=None`) every
token that is not an input is a target.  A sequence modality's `keep`
scheme per mixture component ("random", "all" or "binary") comes from the
alphas config (core/config.py:setup_sampling_mod_info).

TransferMasking (egom2p_tpu/masking/unified.py:TransferMasking; reference:
masking.py:567-746) fixes which modalities are inputs and which are
targets, for transfer finetuning: every token of an input modality is
visible to the encoder, every token of a target modality is a decoder
target; a text modality is packed whole as input or whole as target.
Sequence modalities need a `text_tokenizer` (utils/text_tokenizer.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from egom2p_torch.data.span import (chunk_span_masking, get_sentinel_to_id_mapping,
                                    simple_span_masking)

IMG_TYPES = ("img", "cam", "gaze", "keypoints")
KEEP_DECAY = 0.9  # a sequence's keep probability shrinks by this until its input fits


class _Text:
    """The text tokenizer's ids that span masking needs."""

    def __init__(self, modality_info: Dict, text_tokenizer, what: str):
        self.text_tokenizer = text_tokenizer
        if text_tokenizer is None:
            seq = [m for m, i in modality_info.items() if i["type"] not in IMG_TYPES]
            if seq:
                raise ValueError(f"{what}: sequence modalities {seq} need a text_tokenizer")
            return
        self.sentinel_to_id = get_sentinel_to_id_mapping(text_tokenizer)
        self.sentinel_ids = set(self.sentinel_to_id.values())
        self.pad_id = text_tokenizer.token_to_id("[PAD]")
        self.eos_id = text_tokenizer.token_to_id("[EOS]")

    def text_ids(self, text: str, max_tokens: int) -> List[int]:
        """A caption's ids, [EOS] appended, cut to `max_tokens`."""
        ids = list(self.text_tokenizer.encode(text).ids) + [self.eos_id]
        return ids[:max_tokens]

    def pack(self, input_seq, target_seq, max_tokens: int, target_start: int) -> Dict:
        """(max_tokens + 1) * 2 slots: the input from slot 0, the target
        from `target_start`, [PAD] elsewhere; the target's decoder attention
        is 1 (a causal run)."""
        max_length = (max_tokens + 1) * 2
        tensor = np.full(max_length, self.pad_id, dtype=np.int32)
        input_mask = np.ones(max_length, dtype=bool)
        target_mask = np.ones(max_length, dtype=bool)
        attn = np.zeros(max_length, dtype=np.int32)
        tensor[:len(input_seq)] = input_seq
        input_mask[:len(input_seq)] = False
        end = target_start + len(target_seq)
        tensor[target_start:end] = target_seq
        target_mask[target_start:end] = False
        attn[target_start:end] = 1
        return {"tensor": tensor, "input_mask": input_mask,
                "target_mask": target_mask, "decoder_attention_mask": attn}


def _to2tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class UnifiedMasking(_Text):
    def __init__(self,
                 modality_info: Dict,
                 input_tokens_range: Union[int, Tuple[int, int]],
                 target_tokens_range: Optional[Union[int, Tuple[int, int]]],
                 sampling_weights: Optional[Sequence[float]],
                 seed: Optional[int] = None,
                 max_tries: int = 100,
                 text_tokenizer=None):
        """`sampling_weights` weigh the Dirichlet mixture's components, or
        are None (setup_sampling_mod_info's value for a dataset without an
        alphas config): then each sample draws its component uniformly.  A
        token range is an int or an inclusive (low, high) pair; a
        `target_tokens_range` of None makes every non-input token a target."""
        super().__init__(modality_info, text_tokenizer, "UnifiedMasking")
        self.input_tokens_range = _to2tuple(input_tokens_range)
        self.target_tokens_range = (None if target_tokens_range is None
                                    else _to2tuple(target_tokens_range))
        self.modality_info = modality_info
        self.max_tries = max_tries
        self.min_tokens = np.array([m["min_tokens"] for m in modality_info.values()])
        self.max_tokens = np.array([m["max_tokens"] for m in modality_info.values()])
        self.mod_is_not_seq = np.array([m["type"] in IMG_TYPES for m in modality_info.values()])
        eps = 1e-9
        input_alphas = np.array([m["input_alphas"] for m in modality_info.values()])
        target_alphas = np.array([m["target_alphas"] for m in modality_info.values()])
        # (nmod, nmix) -> (nmix, nmod)
        self.input_alphas = np.clip(input_alphas.T, eps, None)
        self.target_alphas = np.clip(target_alphas.T, eps, None)
        if self.input_alphas.shape != self.target_alphas.shape:
            raise ValueError("input and target alphas need the same mixture size")
        self.num_dirichlets = self.input_alphas.shape[0]
        if sampling_weights is None:
            self.sampling_p = None
        else:
            w = np.asarray(sampling_weights, dtype=np.float64)
            self.sampling_p = w / w.sum()
        self.rng = np.random.default_rng(seed)

    def _budget(self, alphas, total: int, cap) -> List[int]:
        """Dirichlet split of `total` tokens, capped per modality, redrawn
        until every modality meets its minimum (reference: masking.py:181-234)."""
        for _ in range(self.max_tries):
            budget = np.floor(self.rng.dirichlet(alphas) * total).astype(int)
            diff = total - budget.sum()
            if diff > 0:
                # remaining tokens by argmax of fresh draws, so near-zero-alpha
                # modalities stay empty
                draws = self.rng.dirichlet(alphas, size=diff)
                budget += np.bincount(draws.argmax(-1), minlength=len(budget))
            budget = np.minimum(budget, cap)
            if (budget >= self.min_tokens).all():
                return budget.tolist()
        return budget.tolist()

    def image_mask(self, tensor: np.ndarray, num_tokens: int,
                   input_budget: int, target_budget: Optional[int]) -> Dict:
        """(reference: masking.py:236-266)"""
        ids_shuffle = self.rng.permutation(num_tokens)
        input_mask = np.ones(num_tokens, dtype=bool)
        input_mask[:input_budget] = False
        input_mask = input_mask[ids_shuffle]
        if target_budget is None:
            target_mask = ~input_mask
        else:
            target_mask = np.ones(num_tokens, dtype=bool)
            target_mask[input_budget:input_budget + target_budget] = False
            target_mask = target_mask[ids_shuffle]
        attn = np.zeros(num_tokens, dtype=np.int32)
        unmasked = np.where(~target_mask)[0]
        if len(unmasked):
            attn[unmasked[0]] = len(unmasked)
        return {"tensor": np.asarray(tensor), "input_mask": input_mask,
                "target_mask": target_mask, "decoder_attention_mask": attn}

    def _span_budgeted(self, seq_ids, input_budget: int, target_budget: Optional[int],
                       keep_scheme: str, span_fn) -> Tuple[List[int], List[int]]:
        """Span masking whose keep probability decays until the input fits
        `input_budget`, then a target cut to `target_budget` at a sentinel
        (reference: masking.py:287-341)."""
        if input_budget == 0:
            input_seq: List[int] = []
            _, target_seq = span_fn(seq_ids, self.sentinel_to_id, 0.0, self.rng)
        else:
            if keep_scheme == "random":
                keep_prob = self.rng.uniform(0, 1)
            elif keep_scheme == "all":
                keep_prob = 1.0
            elif keep_scheme == "binary":
                keep_prob = float(self.rng.integers(0, 2))
            else:
                raise ValueError(f"keep scheme {keep_scheme!r}")
            input_seq, target_seq = span_fn(seq_ids, self.sentinel_to_id, keep_prob, self.rng)
            while len(input_seq) > input_budget:
                keep_prob *= KEEP_DECAY
                input_seq, target_seq = span_fn(seq_ids, self.sentinel_to_id, keep_prob,
                                                self.rng)
        if target_budget is not None and len(target_seq) > target_budget:
            sentinel_idx = [i for i, t in enumerate(target_seq) if t in self.sentinel_ids]
            chosen = self.rng.integers(0, max(1, len(sentinel_idx) - 1))
            if len(target_seq) - sentinel_idx[chosen] >= target_budget:
                s = sentinel_idx[chosen]
                target_seq = target_seq[s:s + target_budget]
            else:
                for idx in sentinel_idx:
                    if len(target_seq) - idx <= target_budget:
                        target_seq = target_seq[idx:]
                        break
        return input_seq, target_seq

    def sequence_mask(self, sequence, max_tokens: int, input_budget: int,
                      target_budget: Optional[int], keep_scheme: str) -> Dict:
        """A caption (str: token spans) or a list of strings (chunk spans)
        (reference: masking.py:345-445)."""
        if isinstance(sequence, str):
            seq_ids, span_fn = self.text_ids(sequence, max_tokens), simple_span_masking
        elif isinstance(sequence, list):
            seq_ids = [list(e.ids) for e in self.text_tokenizer.encode_batch(sequence)]
            seq_ids.append([self.eos_id])
            cum = np.cumsum([len(c) for c in seq_ids])
            seq_ids = [c for c, n in zip(seq_ids, cum) if n <= max_tokens]
            span_fn = chunk_span_masking
        else:
            raise ValueError(f"a sequence is a str or a list of str, not {type(sequence)}")
        input_seq, target_seq = self._span_budgeted(seq_ids, input_budget, target_budget,
                                                    keep_scheme, span_fn)
        return self.pack(input_seq, target_seq, max_tokens, input_budget)

    def sequence_token_mask(self, sequence_ids, max_tokens: int, input_budget: int,
                            target_budget: Optional[int], keep_scheme: str,
                            vocab_offset: int) -> Dict:
        """Pre-tokenized sequences, e.g. global feature tokens
        (reference: masking.py:268-343)."""
        seq_ids = [int(t) + vocab_offset for t in sequence_ids]
        input_seq, target_seq = self._span_budgeted(seq_ids, input_budget, target_budget,
                                                    keep_scheme, simple_span_masking)
        return self.pack(input_seq, target_seq, max_tokens, input_budget)

    def sequence_emb_mask_span(self, emb_tensor, max_tokens: int, input_budget: int,
                               target_budget: Optional[int], keep_scheme: str) -> Dict:
        """Span-masked precomputed embeddings (T5 / CLIP text), input only:
        fake ids that avoid the sentinels stand for the rows, and a
        sentinel's slot stays zero (reference: masking.py:448-518)."""
        emb_tensor = np.asarray(emb_tensor, dtype=np.float32)
        fake_ids: List[int] = []
        emb_by_id = {}
        id_num, i = len(self.sentinel_ids), 0
        while len(fake_ids) < len(emb_tensor):
            if id_num not in self.sentinel_ids:
                fake_ids.append(id_num)
                emb_by_id[id_num] = emb_tensor[i]
                i += 1
            id_num += 1
        input_seq, _ = self._span_budgeted(fake_ids[:max_tokens], input_budget, None,
                                           keep_scheme, simple_span_masking)
        tensor = np.zeros((max_tokens, emb_tensor.shape[1]), dtype=np.float32)
        for j, fid in enumerate(input_seq):
            if fid not in self.sentinel_ids:
                tensor[j] = emb_by_id[fid]
        input_mask = np.ones(max_tokens, dtype=bool)
        input_mask[:len(input_seq)] = False
        return {"tensor": tensor, "input_mask": input_mask,
                "target_mask": np.ones(max_tokens, dtype=bool),
                "decoder_attention_mask": np.zeros(max_tokens, dtype=np.int32)}

    def __call__(self, mod_dict: Dict) -> Dict:
        """(reference: masking.py:519-564)"""
        if self.sampling_p is None:
            dir_idx = int(self.rng.integers(0, self.num_dirichlets))
        else:
            dir_idx = int(self.rng.choice(self.num_dirichlets, p=self.sampling_p))
        n_in = int(self.rng.integers(self.input_tokens_range[0],
                                     self.input_tokens_range[1] + 1))
        input_budget = self._budget(self.input_alphas[dir_idx], n_in, self.max_tokens)
        if self.target_tokens_range is None:
            target_budget = [None] * len(input_budget)
        else:
            n_tgt = int(self.rng.integers(self.target_tokens_range[0],
                                          self.target_tokens_range[1] + 1))
            # a sequence's target may reuse its input's slots
            remaining = np.where(self.mod_is_not_seq,
                                 self.max_tokens - np.asarray(input_budget), self.max_tokens)
            remaining = np.maximum(self.min_tokens, remaining)
            target_budget = self._budget(self.target_alphas[dir_idx], n_tgt, remaining)
        out = {}
        for (mod, info), bi, bt in zip(self.modality_info.items(), input_budget, target_budget):
            mtype, L = info["type"], info["max_tokens"]
            keep = info["keep"][dir_idx] if "keep" in info else "random"
            if mtype in IMG_TYPES:
                out[mod] = self.image_mask(mod_dict[mod], L, bi, bt)
            elif mtype == "seq":
                out[mod] = self.sequence_mask(mod_dict[mod], L, bi, bt, keep)
            elif mtype == "seq_token":
                out[mod] = self.sequence_token_mask(mod_dict[mod], L, bi, bt, keep,
                                                    info.get("vocab_offset", 0))
            elif mtype == "seq_emb":
                out[mod] = self.sequence_emb_mask_span(mod_dict[mod], L, bi, bt, keep)
            else:
                raise ValueError(f"invalid modality type {mtype}")
        return out


class TransferMasking(_Text):
    """Fixed input / target modalities (--input_domains / --target_domains):
    an input modality is all visible and no target, a target modality all
    target (its decoder attention run in one block) and not visible.  A
    modality in neither set raises, as in the JAX package."""

    def __init__(self, modality_info: Dict, input_modalities: Sequence[str],
                 target_modalities: Sequence[str], text_tokenizer=None):
        super().__init__(modality_info, text_tokenizer, "TransferMasking")
        self.modality_info = modality_info
        self.input_modalities = set(input_modalities)
        self.target_modalities = set(target_modalities)

    @staticmethod
    def input_image(tensor, num_tokens: int) -> Dict:
        return {"tensor": np.asarray(tensor),
                "input_mask": np.zeros(num_tokens, dtype=bool),
                "target_mask": np.ones(num_tokens, dtype=bool),
                "decoder_attention_mask": np.zeros(num_tokens, dtype=np.int32)}

    @staticmethod
    def target_image(tensor, num_tokens: int) -> Dict:
        attn = np.zeros(num_tokens, dtype=np.int32)
        attn[0] = num_tokens
        return {"tensor": np.asarray(tensor),
                "input_mask": np.ones(num_tokens, dtype=bool),
                "target_mask": np.zeros(num_tokens, dtype=bool),
                "decoder_attention_mask": attn}

    def _sequence(self, text: str, max_tokens: int, as_input: bool) -> Dict:
        """A caption whole as input (keep_prob 1) or whole as target
        (keep_prob 0, its target from slot max_tokens) (reference:
        masking.py:644-727)."""
        seq_ids = self.text_ids(text, max_tokens)
        rng = np.random.default_rng(0)  # keep_prob 1 or 0: the draws decide nothing
        input_ids, target_ids = simple_span_masking(seq_ids, self.sentinel_to_id,
                                                    1.0 if as_input else 0.0, rng)
        return self.pack(input_ids if as_input else [], target_ids, max_tokens, max_tokens)

    def __call__(self, mod_dict: Dict) -> Dict:
        """(reference: masking.py:729-746)"""
        out = {}
        for mod, info in self.modality_info.items():
            is_input = mod in self.input_modalities
            if not (is_input or mod in self.target_modalities):
                raise ValueError(f"modality {mod} not in input or target set")
            if info["type"] in IMG_TYPES:
                fn = self.input_image if is_input else self.target_image
                out[mod] = fn(mod_dict[mod], info["max_tokens"])
            elif info["type"] == "seq":
                out[mod] = self._sequence(mod_dict[mod], info["max_tokens"], as_input=is_input)
            else:
                raise ValueError(f"TransferMasking does not support type {info['type']!r} "
                                 f"({mod}), as the reference (masking.py:739-744)")
        if "mask_valid" in mod_dict:
            out["mask_valid"] = mod_dict["mask_valid"]
        return out
