"""WordPiece text tokenizer: a reader of `tokenizer.json` with no package
installed, the special-token generators and the trainer.

Port of egom2p_tpu/utils/text_tokenizer.py (reference:
egom2p/utils/tokenizer/text_tokenizer.py:14-140), kept as a copy so that the
port never loads the JAX package.  `WordPieceTokenizer` reads the Hugging
Face `tokenizer.json` format (BertNormalizer -> BertPreTokenizer ->
WordPiece) and offers what the masking and the sampler call:
`token_to_id`, `id_to_token`, `get_vocab`, `encode(text).ids`,
`encode_batch`, `decode`.  `load_text_tokenizer` always returns it: the
card's machine has no `tokenizers` package, and the reader gives the same
ids as that package on the files it writes.  Only
`train_unified_wordpiece_tokenizer` needs `tokenizers`, and imports it
inside its body.

`write_wordpiece_json` writes a small `tokenizer.json` from a word list (the
special tokens, the `[S_i]` sentinels, the words and their `##` pieces),
for tests and smoke runs: the reference's 30000-token file is not in the
repository.
"""
from __future__ import annotations

import json
import re
import unicodedata
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[SOS]", "[EOS]")


@dataclass
class Encoding:
    ids: List[int]
    tokens: List[str]


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    """The BertNormalizer -> BertPreTokenizer -> WordPiece encode pipeline of
    a Hugging Face WordPiece `tokenizer.json` (its parsed dict)."""

    def __init__(self, config: Dict):
        model = config["model"]
        if model.get("type", "WordPiece") != "WordPiece":
            raise ValueError(f"not a WordPiece tokenizer: {model.get('type')}")
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.unk_token = model.get("unk_token", "[UNK]")
        self.prefix = model.get("continuing_subword_prefix", "##")
        self.max_chars = model.get("max_input_chars_per_word", 100)
        norm = config.get("normalizer") or {}
        self.lowercase = norm.get("lowercase", True)
        strip = norm.get("strip_accents")
        self.strip_accents = self.lowercase if strip is None else strip
        self.clean_text = norm.get("clean_text", True)
        self.handle_chinese = norm.get("handle_chinese_chars", True)

        self.added: Dict[str, int] = {}
        self.special: set = set()
        for tok in config.get("added_tokens", []):
            self.added[tok["content"]] = tok["id"]
            self.vocab.setdefault(tok["content"], tok["id"])
            if tok.get("special"):
                self.special.add(tok["content"])
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self._added_re = None
        if self.added:
            alts = sorted(self.added, key=len, reverse=True)
            self._added_re = re.compile("(" + "|".join(re.escape(a) for a in alts) + ")")

    @classmethod
    def from_file(cls, path: str) -> "WordPieceTokenizer":
        with open(path) as f:
            return cls(json.load(f))

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.vocab)

    def get_vocab_size(self) -> int:
        return len(self.vocab)

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def id_to_token(self, idx: int) -> Optional[str]:
        return self.inv_vocab.get(int(idx))

    def _normalize(self, text: str) -> str:
        if self.clean_text:
            # \t \n \r are control characters: they become spaces before the
            # control filter, or words merge across line breaks
            text = "".join(
                " " if ch in ("\t", "\n", "\r") else ch for ch in text
                if ch in ("\t", "\n", "\r") or (
                    ord(ch) not in (0, 0xFFFD)
                    and not unicodedata.category(ch).startswith("C")))
        if self.handle_chinese:
            text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)
        if self.lowercase:
            text = text.lower()
        if self.strip_accents:
            text = "".join(ch for ch in unicodedata.normalize("NFD", text)
                           if unicodedata.category(ch) != "Mn")
        return text

    @staticmethod
    def _pretokenize(text: str) -> List[str]:
        """Whitespace split, every punctuation character a word of its own."""
        words = []
        for blob in text.split():
            cur = ""
            for ch in blob:
                if _is_punctuation(ch):
                    if cur:
                        words.append(cur)
                    words.append(ch)
                    cur = ""
                else:
                    cur += ch
            if cur:
                words.append(cur)
        return words

    def _wordpiece(self, word: str) -> List[str]:
        """Greedy longest-match-first pieces; [UNK] for the whole word when
        a piece is missing."""
        if len(word) > self.max_chars:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end, piece = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def encode(self, text: str) -> Encoding:
        chunks = self._added_re.split(text) if self._added_re else [text]
        tokens: List[str] = []
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self.added:
                tokens.append(chunk)
                continue
            for word in self._pretokenize(self._normalize(chunk)):
                tokens.extend(self._wordpiece(word))
        unk = self.vocab.get(self.unk_token, 0)
        return Encoding(ids=[self.vocab.get(t, unk) for t in tokens], tokens=tokens)

    def encode_batch(self, texts: Iterable[str]) -> List[Encoding]:
        return [self.encode(t) for t in texts]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            t = self.inv_vocab.get(int(i))
            if t is None or (skip_special_tokens and t in self.special):
                continue
            toks.append(t)
        return " ".join(toks).replace(" " + self.prefix, "").strip()


def load_text_tokenizer(path: str) -> WordPieceTokenizer:
    """The reader above on `path` (a WordPiece tokenizer.json)."""
    return WordPieceTokenizer.from_file(path)


# --------------------------------------------------- special-token generators
def generate_sentinel_tokens(num: int = 100, start_id: int = 0) -> List[str]:
    """[S_0]..[S_n] span sentinels (reference: text_tokenizer.py:14-20)."""
    return [f"[S_{i}]" for i in range(start_id, num + start_id)]


def generate_coord_tokens(bins: int = 1000) -> List[str]:
    """v0=..v3= coordinate tokens (reference: text_tokenizer.py:22-33)."""
    return [s.format(i) for s in ("v0={}", "v1={}", "v2={}", "v3={}") for i in range(bins)]


def generate_object_class_tokens(classes: Sequence[str]) -> List[str]:
    """Class-name tokens (reference: text_tokenizer.py:35-44 reads them from
    object_classes.json; pass the list)."""
    return list(classes)


def write_wordpiece_json(path: str, words: Sequence[str], num_sentinels: int = 100) -> str:
    """Write a Hugging Face WordPiece tokenizer.json to `path` (returned)
    with ids [PAD] 0, [UNK] 1, [SOS] 2, [EOS] 3, then [S_0]..[S_{n-1}]
    (special added tokens), then `words`, the ASCII letters, digits and
    punctuation, and each letter and digit as a `##` piece, so that every
    ASCII word encodes (whole where it is listed, else in pieces)."""
    specials = list(SPECIAL_TOKENS) + generate_sentinel_tokens(num_sentinels)
    chars = [chr(c) for c in range(33, 127) if not chr(c).isupper()]
    body = list(dict.fromkeys([w.lower() for w in words] + chars
                              + ["##" + c for c in chars if c.isalnum()]))
    body = [w for w in body if w not in specials]
    vocab = {t: i for i, t in enumerate(specials + body)}
    added = [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True} for t in specials]
    config = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
              "normalizer": {"type": "BertNormalizer", "clean_text": True,
                             "handle_chinese_chars": True, "strip_accents": None,
                             "lowercase": True},
              "pre_tokenizer": {"type": "BertPreTokenizer"}, "post_processor": None,
              "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
              "model": {"type": "WordPiece", "unk_token": "[UNK]",
                        "continuing_subword_prefix": "##", "max_input_chars_per_word": 100,
                        "vocab": vocab}}
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def train_unified_wordpiece_tokenizer(
        files, vocab_size, sentinel_tokens=None, coord_tokens=None,
        object_class_tokens=None, unk_token="[UNK]", pad_token="[PAD]",
        sos_token="[SOS]", eos_token="[EOS]", additional_special_tokens=None,
        min_frequency=0, lowercase=True, wordpieces_prefix="##", show_progress=True):
    """Train a WordPiece tokenizer on text `files` (reference:
    text_tokenizer.py:47-105).  Needs the Hugging Face `tokenizers`
    package, and raises naming it where it is missing; the returned
    tokenizer's `.save(path)` writes a file the reader above loads."""
    try:
        from tokenizers import AddedToken, Tokenizer, decoders, trainers
        from tokenizers.models import WordPiece
        from tokenizers.normalizers import BertNormalizer
        from tokenizers.pre_tokenizers import BertPreTokenizer
    except ImportError as e:
        raise ImportError("training a WordPiece tokenizer needs the `tokenizers` package "
                          "(pip install tokenizers); reading one does not") from e

    tokenizer = Tokenizer(WordPiece(unk_token=str(unk_token)))
    tokenizer.normalizer = BertNormalizer(lowercase=lowercase)
    tokenizer.pre_tokenizer = BertPreTokenizer()
    tokenizer.decoder = decoders.WordPiece(prefix=wordpieces_prefix)
    special = [pad_token, unk_token, sos_token, eos_token]
    for extra in (sentinel_tokens, coord_tokens, object_class_tokens, additional_special_tokens):
        if extra:
            special.extend(AddedToken(content=t, single_word=True, normalized=False)
                           if isinstance(t, str) else t for t in extra)
    trainer = trainers.WordPieceTrainer(
        vocab_size=vocab_size, min_frequency=min_frequency, show_progress=show_progress,
        continuing_subword_prefix=wordpieces_prefix, special_tokens=special)
    tokenizer.train([files] if isinstance(files, str) else list(files), trainer=trainer)
    return tokenizer
