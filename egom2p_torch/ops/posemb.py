"""Fixed sine-cosine positional embeddings (1D/2D/3D).

A copy of egom2p_tpu/ops/posemb.py (pure numpy), so that the port never
imports the JAX package.

Numerically equivalent to the reference builders
(reference: egom2p/models/egom2p_utils.py:32,46,63) which are themselves the
MoCo-v3 style embeddings.  Computed once at module init in fp32 numpy so they
are baked into the param tree as constants.
"""
from __future__ import annotations

import numpy as np


def build_1d_sincos_posemb(max_len: int, embed_dim: int, temperature: float = 10000.0) -> np.ndarray:
    """Returns (1, N, D)."""
    assert embed_dim % 2 == 0
    pos = np.arange(max_len, dtype=np.float32)
    omega = np.arange(embed_dim // 2, dtype=np.float32) / (embed_dim // 2)
    omega = 1.0 / (temperature ** omega)
    out = np.einsum("n,d->nd", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)[None]


def build_2d_sincos_posemb(h: int, w: int, embed_dim: int, temperature: float = 10000.0) -> np.ndarray:
    """Returns (1, H*W, D).  Grid is meshgrid(w, h, indexing='ij') flattened, to
    match the reference ordering exactly (egom2p_utils.py:51-60)."""
    assert embed_dim % 4 == 0
    grid_w = np.arange(w, dtype=np.float32)
    grid_h = np.arange(h, dtype=np.float32)
    grid_w, grid_h = np.meshgrid(grid_w, grid_h, indexing="ij")
    pos_dim = embed_dim // 4
    omega = np.arange(pos_dim, dtype=np.float32) / pos_dim
    omega = 1.0 / (temperature ** omega)
    out_w = np.einsum("n,d->nd", grid_w.reshape(-1), omega)
    out_h = np.einsum("n,d->nd", grid_h.reshape(-1), omega)
    return np.concatenate(
        [np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1
    )[None]


def build_3d_sincos_posemb(t: int, h: int, w: int, embed_dim: int, temperature: float = 10000.0) -> np.ndarray:
    """Returns (1, T*H*W, D), for the 5x32x32 video token grid
    (egom2p_utils.py:63-86)."""
    assert embed_dim % 6 == 0
    channels = int(embed_dim // 6 * 2)
    inv_freq = 1.0 / (temperature ** (np.arange(0, channels, 2, dtype=np.float32) / channels))

    def axis_emb(n):
        pos = np.arange(n, dtype=np.float32)
        sin_inp = np.einsum("i,j->ij", pos, inv_freq)
        # interleave sin/cos: (n, channels)
        return np.stack([np.sin(sin_inp), np.cos(sin_inp)], axis=-1).reshape(n, -1)

    emb_t = axis_emb(t)[:, None, None, :]
    emb_h = axis_emb(h)[None, :, None, :]
    emb_w = axis_emb(w)[None, None, :, :]

    emb = np.zeros((t, h, w, channels * 3), dtype=np.float32)
    emb[..., :channels] = emb_t
    emb[..., channels : 2 * channels] = emb_h
    emb[..., 2 * channels :] = emb_w
    if channels * 3 < embed_dim:
        emb = np.pad(emb, ((0, 0), (0, 0), (0, 0), (0, embed_dim - channels * 3)))
    return emb.reshape(1, t * h * w, embed_dim)
