"""Pillow's Image.resize, computed with numpy and torch.

The port's transforms resize images without Pillow (the card's machine has
none), with Pillow's own arithmetic, so that they give the JAX package's
bytes (egom2p_tpu/data/modality_transforms.py resizes through Pillow):

  * bilinear / bicubic / lanczos: Pillow's separable two-pass resample
    (ImagingResample): the triangle, the a = -0.5 cubic or the 3-lobe
    Lanczos filter, widened by the scale when
    shrinking (antialiased), the horizontal pass first.  8-bit images sum
    22-bit fixed-point coefficients in integers and round each pass to a
    byte; float images sum in float64 and store float32 between passes;
    16-bit images sum in float64 and round half up (Pillow's own 16-bit
    sums land on the other side of an exact half now and then: +-1 level).
  * nearest: Pillow's scale-affine (ImagingScaleAffine), whose source
    coordinates are accumulated by repeated addition.

Images are numpy arrays (H, W) or (H, W, C): uint8, uint16 (one channel)
or float.  tests/test_torch_modality_transforms.py holds every case
against Pillow.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2


def _triangle(x):
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _cubic(x, a=-0.5):
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x):
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x):
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


_FILTERS = {"bilinear": (_triangle, 1.0), "bicubic": (_cubic, 2.0), "lanczos": (_lanczos, 3.0)}


def _coeffs(in_size: int, out_size: int, mode: str) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs over the whole input: (indices (out,
    ksize), float64 coefficients (out, ksize)); taps past a row's bounds
    have coefficient 0 and a clamped index."""
    fn, support = _FILTERS[mode]
    scale = filterscale = in_size / out_size
    filterscale = max(filterscale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(w)  # sequential, as Pillow's loop
        kk[xx, :xmax] = [v / ww if ww != 0.0 else v for v in w]
        idx[xx] = np.minimum(xmin + np.arange(ksize), in_size - 1)
    return idx, kk


def _fixed(kk: np.ndarray) -> np.ndarray:
    """normalize_coeffs_8bpc: coefficients as 22-bit fixed point."""
    scaled = kk * (1 << PRECISION_BITS)
    return np.where(kk < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)


def _pass(x: torch.Tensor, axis: int, idx: np.ndarray, kk: np.ndarray, kind: str) -> torch.Tensor:
    """One resample pass along `axis` of x (H, W, C)."""
    ksize = idx.shape[1]
    if kind == "u8":
        k = torch.from_numpy(_fixed(kk))
        ss = torch.full((), 1 << (PRECISION_BITS - 1), dtype=torch.int64)
        src = x.to(torch.int64)
    else:
        k = torch.from_numpy(kk)
        ss = torch.zeros((), dtype=torch.float64)
        src = x.to(torch.float64)
    for j in range(ksize):  # Pillow's order of the sums
        taps = torch.from_numpy(idx[:, j])
        w = k[:, j]
        shape = [1, 1, 1]
        shape[axis] = -1
        ss = ss + src.index_select(axis, taps) * w.view(shape)
    if kind == "u8":
        return (ss >> PRECISION_BITS).clamp(0, 255).to(torch.uint8)
    if kind == "u16":
        r = torch.where(ss >= 0, ss + 0.5, ss - 0.5).to(torch.int64)
        lo = torch.fmod(r, 256).clamp(0, 255)
        hi = (r >> 8).clamp(0, 255)
        return (hi * 256 + lo).to(torch.int32)
    return ss.to(torch.float32)


def _nearest_index(in_size: int, out_size: int, accumulate: bool) -> np.ndarray:
    """The source index per output index of Pillow's nearest resize: 8-bit
    and float images take ImagingScaleAffine (a[0] * 0.5, then a[0] added
    once per step), 16-bit ones the generic transform (a[0] * (x + 0.5))."""
    a0 = in_size / out_size
    if accumulate:
        steps = np.full(out_size, a0, np.float64)
        steps[0] = a0 * 0.5
        xo = np.add.accumulate(steps)
    else:
        xo = a0 * (np.arange(out_size) + 0.5)
    return np.minimum(xo.astype(np.int64), in_size - 1)


def resize(img: np.ndarray, size: Tuple[int, int], mode: str = "bilinear") -> np.ndarray:
    """Image.fromarray(img).resize((w, h), resample) as numpy: `size` is
    (h, w); `mode` is 'bilinear', 'bicubic', 'lanczos' or 'nearest'."""
    th, tw = size
    h, w = img.shape[:2]
    if img.dtype.kind == "f":
        img = img.astype(np.float32)  # Pillow's 'F' mode
    if (h, w) == (th, tw):
        return img.copy()
    if mode == "nearest":
        acc = img.dtype != np.uint16
        return img[_nearest_index(h, th, acc)][:, _nearest_index(w, tw, acc)]
    if mode not in _FILTERS:
        raise ValueError(f"Resample mode {mode} is not supported.")
    if img.dtype == np.uint8:
        kind = "u8"
    elif img.dtype == np.uint16:
        kind = "u16"
    elif img.dtype.kind == "f":
        kind = "f32"
    else:
        raise ValueError(f"resize takes uint8, uint16 or float images, got {img.dtype}")
    x = torch.from_numpy(np.ascontiguousarray(img))
    x = x[..., None] if x.dim() == 2 else x
    if w != tw:
        x = _pass(x, 1, *_coeffs(w, tw, mode), kind)
    if h != th:
        x = _pass(x, 0, *_coeffs(h, th, mode), kind)
    out = x.numpy().astype(img.dtype)
    return out[..., 0] if img.ndim == 2 else out
