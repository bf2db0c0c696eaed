"""Modality registry.

A copy of egom2p_tpu/data/modality_info.py (no JAX in it), so that the port
never imports the JAX package; ids and specs are identical.

Equivalent of the reference MODALITY_INFO dict
(reference: egom2p/data/modality_info.py:35-441).  The four active modalities
of the released EgoM2P models are tok_rgb / tok_depth / tok_cam / tok_gaze;
caption/det-style sequence modalities are kept for the masking machinery and
future finetunes.  IDs use the same sha256-uint15 hash as the reference
(egom2p/utils/misc.py:40-42) so mod-mask ids and checkpoints interoperate.

Instead of torch nn.Module factory partials, each entry carries a plain
`embed_spec` dict consumed by egom2p_tpu/models/embeddings.py.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict


def generate_uint15_hash(seed_str: str) -> int:
    return int(hashlib.sha256(seed_str.encode("utf-8")).hexdigest(), 16) % (2**15)


def _video_tok(name: str, path: str) -> Dict[str, Any]:
    return {
        "input_size": 256,
        "patch_size": 8,
        "vocab_size": 64000,
        "min_tokens": 0,
        "max_tokens": 5120,  # 5 x 32 x 32 token grid
        "type": "img",
        "id": generate_uint15_hash(name),
        "pretokenized": True,
        "path": path,
        "embed_spec": {"kind": "video_token", "vocab_size": 64000, "grid": (5, 32, 32)},
    }


def _seq30_tok(name: str, path: str, mod_type: str) -> Dict[str, Any]:
    return {
        "vocab_size": 256,
        "min_tokens": 0,
        "max_tokens": 30,
        "type": mod_type,
        "id": generate_uint15_hash(name),
        "pretokenized": True,
        "path": path,
        "embed_spec": {"kind": "gazecam_token", "vocab_size": 256, "length": 30},
    }


def _text_seq(name: str) -> Dict[str, Any]:
    return {
        "vocab_size": 30_000,
        "min_tokens": 0,
        "max_tokens": 256,
        "type": "seq",
        "id": generate_uint15_hash(name),
        "embed_spec": {
            "kind": "sequence",
            "vocab_size": 30_000,
            "max_length": 256,
            "padding_idx": 0,
        },
    }


def _image_tok(name: str, vocab_size: int, input_size: int = 224, patch_size: int = 16) -> Dict[str, Any]:
    n = (input_size // patch_size) ** 2
    return {
        "input_size": input_size,
        "patch_size": patch_size,
        "vocab_size": vocab_size,
        "min_tokens": 0,
        "max_tokens": n,
        "type": "img",
        "id": generate_uint15_hash(name),
        "pretokenized": True,
        "embed_spec": {
            "kind": "image_token",
            "vocab_size": vocab_size,
            "grid": (input_size // patch_size, input_size // patch_size),
        },
    }


def make_scaled_modality_info(video_grid=(2, 4, 4), video_vocab=96,
                              seq_len=8, seq_vocab=32) -> Dict[str, Dict[str, Any]]:
    """Scaled-down copy of the four active modalities (tiny vocabs/grids) for
    CPU tests and multi-chip dry runs on virtual devices."""
    import copy
    import math
    info = copy.deepcopy({m: MODALITY_INFO[m]
                          for m in ("tok_rgb", "tok_depth", "tok_cam", "tok_gaze")})
    n_video = int(math.prod(video_grid))
    for m in ("tok_rgb", "tok_depth"):
        info[m].update(vocab_size=video_vocab, max_tokens=n_video)
        info[m]["embed_spec"] = {"kind": "video_token", "vocab_size": video_vocab,
                                 "grid": tuple(video_grid)}
    for m in ("tok_cam", "tok_gaze"):
        info[m].update(vocab_size=seq_vocab, max_tokens=seq_len)
        info[m]["embed_spec"] = {"kind": "gazecam_token", "vocab_size": seq_vocab,
                                 "length": seq_len}
    return info


MODALITY_INFO: Dict[str, Dict[str, Any]] = {
    # --- active four (reference: modality_info.py:59-141) ---
    "tok_rgb": _video_tok("tok_rgb", "rgb"),
    "tok_depth": _video_tok("tok_depth", "depth"),
    "tok_cam": _seq30_tok("tok_cam", "cam", "cam"),
    "tok_gaze": _seq30_tok("tok_gaze", "gaze", "gaze"),
    # --- raw-pixel encoder modality (reference: modality_info.py:36-46,
    #     ImageEncoderEmbedding; input-only) ---
    "rgb@224": {
        "input_size": 224, "patch_size": 16, "num_channels": 3,
        "min_tokens": 0, "max_tokens": 196, "type": "img",
        "id": generate_uint15_hash("rgb@224"),
        "embed_spec": {"kind": "image_raw", "num_channels": 3,
                       "patch_size": 16, "image_size": 224},
    },
    # --- precomputed text-embedding modality (reference:
    #     modality_info.py:212-219, SequenceEmbEncoderEmbedding; input-only) ---
    "t5_caption": {
        "min_tokens": 0, "max_tokens": 77, "type": "seq_emb",
        "id": generate_uint15_hash("t5_caption"),
        "embed_spec": {"kind": "sequence_emb", "max_length": 77,
                       "orig_emb_dim": 4096},
    },
    # --- raw (tokenizer-training) modalities ---
    "rgb": {"type": "img", "num_channels": 3, "id": generate_uint15_hash("rgb"), "path": "rgb"},
    "depth": {"type": "img", "num_channels": 1, "id": generate_uint15_hash("depth")},
    "cam": {"type": "cam", "num_channels": 9, "id": generate_uint15_hash("cam")},
    "gaze": {"type": "gaze", "num_channels": 2, "id": generate_uint15_hash("gaze")},
    # --- sequence modalities (span masking machinery; finetunes) ---
    "caption": _text_seq("caption"),
    "det": _text_seq("det"),
    # --- legacy 4M modalities (checkpoint key compatibility; reference:
    #     modality_info.py:86-441) ---
    "tok_rgb@224": _image_tok("tok_rgb@224", 16384),
    "tok_depth@224": _image_tok("tok_depth@224", 8192),
    "tok_normal@224": _image_tok("tok_normal@224", 8192),
    "tok_semseg@224": _image_tok("tok_semseg@224", 4096),
    "tok_clip@224": _image_tok("tok_clip@224", 8192),
    "tok_canny_edge@224": _image_tok("tok_canny_edge@224", 8192),
    "tok_sam_edge@224": _image_tok("tok_sam_edge@224", 8192),
    "tok_dinov2@224": _image_tok("tok_dinov2@224", 8192, patch_size=14),
    "tok_imagebind@224": _image_tok("tok_imagebind@224", 8192, patch_size=14),
    "rgb@448": {
        "input_size": 448, "patch_size": 16, "num_channels": 3,
        "min_tokens": 0, "max_tokens": 784, "type": "img",
        "id": generate_uint15_hash("rgb@448"),
        "embed_spec": {"kind": "image_raw", "num_channels": 3,
                       "patch_size": 16, "image_size": 448},
    },
    "tok_rgb@448": _image_tok("tok_rgb@448", 16384, input_size=448),
    "tok_depth@448": _image_tok("tok_depth@448", 8192, input_size=448),
    "tok_normal@448": _image_tok("tok_normal@448", 8192, input_size=448),
    "tok_semseg@448": _image_tok("tok_semseg@448", 4096, input_size=448),
    "tok_clip@448": _image_tok("tok_clip@448", 8192, input_size=448),
    # global feature tokens: 4x4 grids with learned (non-sincos) posembs in
    # the reference; the fixed-grid embedding covers checkpoint shape compat
    "tok_dinov2_global": _image_tok("tok_dinov2_global", 8192,
                                    input_size=224, patch_size=56),
    "tok_imagebind_global": _image_tok("tok_imagebind_global", 8192,
                                       input_size=224, patch_size=56),
    # legacy text-ish sequence modalities (shared 30k WordPiece vocab)
    "metadata": dict(_text_seq("metadata"), max_tokens=40, path="metadata",
                     embed_spec={"kind": "sequence", "vocab_size": 30_000,
                                 "max_length": 40, "padding_idx": 0}),
    "human_poses": dict(_text_seq("human_poses"), max_tokens=275,
                        embed_spec={"kind": "sequence", "vocab_size": 30_000,
                                    "max_length": 275, "padding_idx": 0}),
    "color_palette": dict(_text_seq("color_palette"), max_tokens=23,
                          path="color_palette",
                          embed_spec={"kind": "sequence",
                                      "vocab_size": 30_000,
                                      "max_length": 23, "padding_idx": 0}),
    "sam_instance": dict(_text_seq("sam_instance"), max_tokens=290,
                         embed_spec={"kind": "sequence",
                                     "vocab_size": 30_000,
                                     "max_length": 290, "padding_idx": 0}),
    # tokenizer-training-side raw modalities (no transformer embeddings)
    "normal": {"type": "img", "num_channels": 3,
               "id": generate_uint15_hash("normal")},
    "semseg_coco": {"type": "img", "num_channels": 64,
                    "id": generate_uint15_hash("semseg_coco")},
    "sam_mask": {"type": "img", "num_channels": 1, "min_tokens": 0,
                 "max_tokens": 64, "id": generate_uint15_hash("sam_mask")},
    "CLIP-B16": {"type": "feature_map", "num_channels": 512,
                 "id": generate_uint15_hash("CLIP-B16")},
    "DINOv2-B14": {"type": "feature_map",
                   "id": generate_uint15_hash("DINOv2-B14")},
    "ImageBind-H14": {"type": "feature_map",
                      "id": generate_uint15_hash("ImageBind-H14")},
    "DINOv2-B14-global": {"type": "feature_map",
                          "id": generate_uint15_hash("DINOv2-B14-global")},
    "ImageBind-H14-global": {"type": "feature_map",
                             "id": generate_uint15_hash("ImageBind-H14-global")},
}
