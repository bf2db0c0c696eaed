"""Unified Dirichlet-budget masking, the pretraining objective, for
image-type modalities.

Numpy port of egom2p_tpu/masking/unified.py:UnifiedMasking (reference:
egom2p/data/masking.py:131-266), restricted to the modality types the ported
model trains on (img, cam, gaze, keypoints): per sample, input and target
token budgets per modality from a mixture of Dirichlet distributions (clamp
and retry to respect the min/max token counts), then a random-permutation
keep-k per modality with the cumsum-compressed decoder attention encoding.
The random draws come in the JAX package's order, so one seed gives the
same masks in both.  Without `sampling_weights` the mixture component is a
uniform draw; without a target budget (`target_tokens_range=None`) every
token that is not an input is a target.

TransferMasking (egom2p_tpu/masking/unified.py:TransferMasking; reference:
masking.py:567-746) fixes which modalities are inputs and which are
targets, for transfer finetuning: every token of an input modality is
visible to the encoder, every token of a target modality is a decoder
target.

Not ported yet: sequence modalities (span masking and the text tokenizer).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

IMG_TYPES = ("img", "cam", "gaze", "keypoints")


def _to2tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class UnifiedMasking:
    def __init__(self,
                 modality_info: Dict,
                 input_tokens_range: Union[int, Tuple[int, int]],
                 target_tokens_range: Optional[Union[int, Tuple[int, int]]],
                 sampling_weights: Optional[Sequence[float]],
                 seed: Optional[int] = None,
                 max_tries: int = 100):
        """`sampling_weights` weigh the Dirichlet mixture's components, or
        are None (setup_sampling_mod_info's value for a dataset without an
        alphas config): then each sample draws its component uniformly.  A
        token range is an int or an inclusive (low, high) pair; a
        `target_tokens_range` of None makes every non-input token a target."""
        bad = [m for m, i in modality_info.items() if i["type"] not in IMG_TYPES]
        if bad:
            raise NotImplementedError(f"sequence-modality masking is not ported yet: {bad}")
        self.input_tokens_range = _to2tuple(input_tokens_range)
        self.target_tokens_range = (None if target_tokens_range is None
                                    else _to2tuple(target_tokens_range))
        self.modality_info = modality_info
        self.max_tries = max_tries
        self.min_tokens = np.array([m["min_tokens"] for m in modality_info.values()])
        self.max_tokens = np.array([m["max_tokens"] for m in modality_info.values()])
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
            remaining = np.maximum(self.min_tokens,
                                   self.max_tokens - np.asarray(input_budget))
            target_budget = self._budget(self.target_alphas[dir_idx], n_tgt, remaining)
        return {mod: self.image_mask(mod_dict[mod], info["max_tokens"], bi, bt)
                for (mod, info), bi, bt in zip(self.modality_info.items(),
                                               input_budget, target_budget)}


class TransferMasking:
    """Fixed input / target modalities (--input_domains / --target_domains):
    an input modality is all visible and no target, a target modality all
    target (its decoder attention run in one block) and not visible.  A
    modality in neither set raises, as in the JAX package; text modalities
    are not ported."""

    def __init__(self, modality_info: Dict, input_modalities: Sequence[str],
                 target_modalities: Sequence[str]):
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
                raise NotImplementedError(f"{mod}: text modalities are not ported")
            else:
                raise ValueError(f"TransferMasking does not support type {info['type']!r} "
                                 f"({mod}), as the reference (masking.py:739-744)")
        if "mask_valid" in mod_dict:
            out["mask_valid"] = mod_dict["mask_valid"]
        return out
