"""T5-style sentinel span masking for sequence modalities.

A copy of egom2p_tpu/masking/span.py (pure Python and numpy; reference:
egom2p/data/masking.py:58-127, egom2p/utils/tokenizer/text_tokenizer.py:
110-140), kept in the port so that it never loads the JAX package.  The
span functions take the same `np.random.Generator` draws in the same order
as the JAX package's, so one seed gives the same spans in both.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _span_mask(items: Sequence, sentinel_to_id: Dict[int, int], keep_prob: float,
               rng: np.random.Generator, extend) -> Tuple[List[int], List[int]]:
    """Each item is dropped from the input with probability 1 - keep_prob
    (one draw per item); each run of dropped items becomes one sentinel in
    the input, and the target lists each sentinel and its run, then the
    next sentinel as the end."""
    masks = rng.random(len(items)) > keep_prob
    input_seq: List[int] = []
    target_seq: List[int] = []
    prev_mask = False
    sentinel_count = 0
    for item, mask in zip(items, masks):
        if mask:
            if not prev_mask:
                sentinel_count += 1
                input_seq.append(sentinel_to_id[sentinel_count])
                target_seq.append(sentinel_to_id[sentinel_count])
            prev_mask = True
            extend(target_seq, item)
        else:
            prev_mask = False
            extend(input_seq, item)
    target_seq.append(sentinel_to_id[sentinel_count + 1])
    return input_seq, target_seq


def simple_span_masking(sequence: Sequence[int], sentinel_to_id: Dict[int, int],
                        keep_prob: float, rng: np.random.Generator) -> Tuple[List[int], List[int]]:
    """Span masking at token granularity (reference: masking.py:58-91)."""
    return _span_mask(sequence, sentinel_to_id, keep_prob, rng,
                      lambda seq, token: seq.append(int(token)))


def chunk_span_masking(chunks: Sequence[Sequence[int]], sentinel_to_id: Dict[int, int],
                       keep_prob: float, rng: np.random.Generator) -> Tuple[List[int], List[int]]:
    """Span masking at chunk granularity (reference: masking.py:94-127)."""
    return _span_mask(chunks, sentinel_to_id, keep_prob, rng,
                      lambda seq, chunk: seq.extend(int(t) for t in chunk))


def get_sentinel_to_id_mapping(tokenizer, match_str: str = "[S_") -> Dict[int, int]:
    """{i: id of [S_i]} (reference: text_tokenizer.py:110-115)."""
    sentinels = {k: v for k, v in tokenizer.get_vocab().items() if k.startswith(match_str)}
    return {int(k.split("_")[1][:-1]): v
            for k, v in sorted(sentinels.items(), key=lambda kv: kv[1])}


def split_by_sentinel(seq_ids, sentinel_ids):
    """{sentinel id: the tokens after it, up to the next sentinel}
    (reference: text_tokenizer.py:118-127)."""
    splits = defaultdict(list)
    cur = None
    for token in seq_ids:
        if token in sentinel_ids:
            cur = token
        else:
            splits[cur].append(token)
    return splits


def merge_span_masking(input_seq, decoder_seq, sentinel_ids):
    """The input with each sentinel replaced by its predicted span
    (reference: text_tokenizer.py:130-138)."""
    decoder_splits = split_by_sentinel(decoder_seq, sentinel_ids)
    out = []
    for token in input_seq:
        if token in sentinel_ids:
            out.extend(decoder_splits[token])
        else:
            out.append(token)
    return out
