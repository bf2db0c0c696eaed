"""The port's text path on the host against the JAX package: the WordPiece
tokenizer on a tokenizer.json the test writes, the span functions, and the
sequence branches of UnifiedMasking / TransferMasking with a caption among
image modalities (bitwise-equal dicts over seeded samples, every keep
scheme, `seq`, `seq_token` and `seq_emb`)."""
import builtins
import copy

import numpy as np
import pytest

from egom2p_torch.data import span as tspan
from egom2p_torch.data.masking import TransferMasking, UnifiedMasking
from egom2p_torch.utils import text_tokenizer as ttok
from egom2p_tpu.data.modality_info import generate_uint15_hash
from egom2p_tpu.masking import span as jspan
from egom2p_tpu.masking.unified import TransferMasking as JaxTransferMasking
from egom2p_tpu.masking.unified import UnifiedMasking as JaxUnifiedMasking
from egom2p_tpu.utils import text_tokenizer as jtok

from test_torch_model import tiny_info

WORDS = ("a man walks the dog in the park while it rains , holding an umbrella over "
         "his head and talking on the phone ; kitchen table cup pour water hand left "
         "right open close door walk ##ing ##ed ##s").split()
TEXTS = ["A man walks the dog.", "holding an UMBRELLA, talking!", "pouring water (left hand)",
         "Xylophones clatter; déjà vu 42 times", "[S_2] open [S_3] the door", "tab\tand\nnewline",
         "zzzqqq unknownish", ""]
N_SAMPLES = 50


@pytest.fixture(scope="module")
def tok_path(tmp_path_factory):
    return ttok.write_wordpiece_json(str(tmp_path_factory.mktemp("tok") / "tokenizer.json"),
                                     WORDS, num_sentinels=16)


class _JaxReader(jtok.WordPieceTokenizer):
    """The JAX package's reader with the `encode_batch` its masking calls
    for a list of strings (the Hugging Face tokenizer's method)."""

    def encode_batch(self, texts):
        return [self.encode(t) for t in texts]


def test_tokenizer_matches_jax_reader(tok_path):
    port = ttok.load_text_tokenizer(tok_path)
    ref = jtok.WordPieceTokenizer.from_file(tok_path)
    assert isinstance(port, ttok.WordPieceTokenizer)
    assert port.get_vocab() == ref.get_vocab() and port.get_vocab_size() == ref.get_vocab_size()
    for name in ("[PAD]", "[UNK]", "[SOS]", "[EOS]", "[S_0]", "[S_15]", "walk", "##ing", "zz"):
        assert port.token_to_id(name) == ref.token_to_id(name), name
    assert [port.token_to_id(t) for t in ttok.SPECIAL_TOKENS] == [0, 1, 2, 3]
    assert port.token_to_id("[S_1]") == 5  # the sampler's default s1_id
    for text in TEXTS:
        a, b = port.encode(text), ref.encode(text)
        assert a.ids == b.ids and a.tokens == b.tokens, text
        assert port.decode(a.ids) == ref.decode(b.ids)
        assert port.decode(a.ids, skip_special_tokens=False) == ref.decode(
            b.ids, skip_special_tokens=False)
    assert [e.ids for e in port.encode_batch(TEXTS)] == [ref.encode(t).ids for t in TEXTS]
    enc = port.encode("walking dogs, zq")  # whole words, ## pieces, punctuation, unknown
    assert "##ing" in enc.tokens and "," in enc.tokens and port.id_to_token(enc.ids[0]) == "walk"
    for i in range(port.get_vocab_size()):
        assert port.id_to_token(i) == ref.id_to_token(i)


def test_tokenizer_matches_hugging_face(tok_path):
    """The file is a Hugging Face tokenizer.json: that package reads the
    same ids from it (where it is installed)."""
    tokenizers = pytest.importorskip("tokenizers")
    hf = tokenizers.Tokenizer.from_file(tok_path)
    port = ttok.load_text_tokenizer(tok_path)
    for text in TEXTS:
        assert port.encode(text).ids == hf.encode(text).ids, text


def test_special_token_generators_match_jax():
    assert ttok.generate_sentinel_tokens(7, 3) == jtok.generate_sentinel_tokens(7, 3)
    assert ttok.generate_coord_tokens(12) == jtok.generate_coord_tokens(12)
    assert ttok.generate_object_class_tokens(["cup", "door"]) == \
        jtok.generate_object_class_tokens(["cup", "door"])


def test_training_a_tokenizer_names_its_package(tmp_path, monkeypatch):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(" ".join(WORDS) * 20)
    real_import = builtins.__import__

    def no_tokenizers(name, *a, **kw):
        if name == "tokenizers" or name.startswith("tokenizers."):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    with monkeypatch.context() as m:
        m.setattr(builtins, "__import__", no_tokenizers)
        with pytest.raises(ImportError, match="`tokenizers` package"):
            ttok.train_unified_wordpiece_tokenizer(str(corpus), 200)
    pytest.importorskip("tokenizers")
    trained = ttok.train_unified_wordpiece_tokenizer(
        str(corpus), 200, sentinel_tokens=ttok.generate_sentinel_tokens(4), show_progress=False)
    trained.save(str(tmp_path / "t.json"))
    port = ttok.load_text_tokenizer(str(tmp_path / "t.json"))
    assert port.encode("the dog walks").ids == trained.encode("the dog walks").ids


@pytest.mark.parametrize("seed", range(10))
def test_span_functions_match_jax(tok_path, seed):
    tok = ttok.load_text_tokenizer(tok_path)
    s2id = tspan.get_sentinel_to_id_mapping(tok)
    assert s2id == jspan.get_sentinel_to_id_mapping(tok) and s2id[1] == 5
    rng = np.random.default_rng(seed)
    seq = rng.integers(30, 90, rng.integers(1, 30)).tolist()
    chunks = [rng.integers(30, 90, rng.integers(1, 5)).tolist() for _ in range(6)]
    keep = float(rng.uniform())
    for fn in ("simple_span_masking", "chunk_span_masking"):
        arg = seq if fn == "simple_span_masking" else chunks
        a = getattr(tspan, fn)(arg, s2id, keep, np.random.default_rng(seed))
        b = getattr(jspan, fn)(arg, s2id, keep, np.random.default_rng(seed))
        assert a == b, fn
    inp, tgt = tspan.simple_span_masking(seq, s2id, keep, np.random.default_rng(seed))
    ids = set(s2id.values())
    assert dict(tspan.split_by_sentinel(tgt, ids)) == dict(jspan.split_by_sentinel(tgt, ids))
    merged = tspan.merge_span_masking(inp, tgt, ids)
    assert merged == jspan.merge_span_masking(inp, tgt, ids) == seq


def _text_info(keep, extra=()):
    """tok_rgb and tok_cam (tiny grids) around a 12-slot caption, with
    4-component alphas and the caption's keep scheme per component."""
    info = {m: tiny_info()[m] for m in ("tok_rgb", "tok_cam")}
    info["caption"] = {"vocab_size": 64, "min_tokens": 0, "max_tokens": 12, "type": "seq",
                       "id": generate_uint15_hash("caption"),
                       "embed_spec": {"kind": "sequence", "vocab_size": 64, "max_length": 12}}
    if "seq_token" in extra:
        info["feat"] = {"vocab_size": 64, "min_tokens": 0, "max_tokens": 8,
                        "type": "seq_token", "vocab_offset": 20,
                        "id": generate_uint15_hash("feat")}
    if "seq_emb" in extra:
        info["t5"] = {"min_tokens": 0, "max_tokens": 6, "type": "seq_emb",
                      "id": generate_uint15_hash("t5"),
                      "embed_spec": {"kind": "sequence_emb", "max_length": 6,
                                     "orig_emb_dim": 5}}
    info["tok_depth"] = tiny_info()["tok_depth"]  # an image modality after the caption
    for m in info:
        info[m] = dict(info[m], input_alphas=[0.01, 0.1, 1.0, 10.0],
                       target_alphas=[0.01, 0.1, 1.0, 10.0])
        if info[m]["type"] != "img" and info[m]["type"] != "cam":
            info[m]["keep"] = [keep] * 4
    return info


def _samples(info, n, list_captions=False):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        s = {}
        for m, inf in info.items():
            if inf["type"] == "seq":
                words = [WORDS[j] for j in rng.integers(0, len(WORDS), rng.integers(0, 14))]
                s[m] = ([" ".join(words[j::3]) for j in range(3)] if list_captions
                        else " ".join(words))
            elif inf["type"] == "seq_token":
                s[m] = rng.integers(0, 40, rng.integers(1, 8)).tolist()
            elif inf["type"] == "seq_emb":
                s[m] = rng.normal(size=(int(rng.integers(1, 6)), 5)).astype(np.float32)
            else:
                s[m] = rng.integers(0, inf["vocab_size"], inf["max_tokens"]).astype(np.int32)
        out.append(s)
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for m in b:
        assert a[m].keys() == b[m].keys(), m
        for k in b[m]:
            np.testing.assert_array_equal(a[m][k], b[m][k], err_msg=f"{m} {k}")
            assert a[m][k].dtype == b[m][k].dtype, (m, k)


@pytest.mark.parametrize("keep,extra,list_captions,ranges", [
    ("random", (), False, (12, 12)),
    ("all", (), False, ((4, 20), (4, 20))),
    ("binary", (), False, (12, None)),
    ("random", (), True, (12, 12)),
    ("random", ("seq_token", "seq_emb"), False, ((6, 18), (6, 18))),
])
def test_unified_masking_with_a_caption_matches_jax(tok_path, keep, extra, list_captions, ranges):
    """The Dirichlet, budget, span and image-mask draws come in JAX's order
    with a caption between image modalities: 50 samples bitwise equal."""
    info = _text_info(keep, extra)
    port_tok = ttok.load_text_tokenizer(tok_path)
    port = UnifiedMasking(info, ranges[0], ranges[1], sampling_weights=[1, 2, 3, 4], seed=11,
                          text_tokenizer=port_tok)
    ref = JaxUnifiedMasking(info, _JaxReader.from_file(tok_path), ranges[0], ranges[1],
                            sampling_weights=[1, 2, 3, 4], seed=11)
    seen_target = seen_input = False
    for sample in _samples(info, N_SAMPLES, list_captions):
        a, b = port(copy.deepcopy(sample)), ref(copy.deepcopy(sample))
        _assert_same(a, b)
        cap = a["caption"]
        assert cap["tensor"].shape == (26,)
        seen_target |= bool((~cap["target_mask"]).any())
        seen_input |= bool((~cap["input_mask"]).any())
    assert seen_target and (seen_input or keep == "binary")


def test_transfer_masking_with_a_caption_matches_jax(tok_path):
    info = _text_info("random")
    port_tok = ttok.load_text_tokenizer(tok_path)
    ref_tok = jtok.WordPieceTokenizer.from_file(tok_path)
    for inputs, targets in ((["tok_rgb", "caption"], ["tok_cam", "tok_depth"]),
                            (["tok_rgb", "tok_cam"], ["caption", "tok_depth"])):
        port = TransferMasking(info, inputs, targets, port_tok)
        ref = JaxTransferMasking(info, ref_tok, inputs, targets)
        for sample in _samples(info, 5):
            _assert_same(port(sample), ref(sample))
    out = TransferMasking(info, ["tok_rgb", "tok_cam"], ["caption", "tok_depth"],
                          port_tok)(_samples(info, 1)[0])["caption"]
    assert out["input_mask"].all() and not out["target_mask"][12:13].any()
