"""RandAugment and RandomErasing for raw-pixel clips, computed with torch.

Port of egom2p_tpu/data/rand_augment.py (reference:
egom2p/data/rand_augment.py:42-530, egom2p/data/random_erasing.py:27-175):
the same op set, magnitude -> argument maps, config-string grammar
('rand-m9-n3-mstd0.5-inc1') and np.random.Generator draws in the same order,
so one seed picks the same ops, magnitudes and resamples as the JAX package.

The JAX module computes every pixel with Pillow, one frame at a time; the
port computes them with torch on a (T, H, W, C) uint8 tensor, so it needs
no Pillow.  Each frame keeps its own statistics (histograms, means), as
Pillow's per-frame calls do:

  * the lookup-table ops (invert, posterize, solarize, solarize_add,
    equalize, auto_contrast) build Pillow's tables and give its bytes;
  * the blend ops (brightness, color, contrast, sharpness) blend with a
    float32 factor and truncate, as Pillow's ImagingBlend; color's grey is
    Pillow's fixed-point L conversion, contrast's the rounded mean of L,
    sharpness's the 3x3 SMOOTH filter (1, 1, 1 / 1, 5, 1 / 1, 1, 1) / 13
    with the border pixels kept;
  * the affine ops (shear, translate, rotate) map each output pixel centre
    through Pillow's inverse matrix, fill outside the image, and sample
    bilinearly or with Pillow's affine bicubic (the cubic convolution of
    a = -1, not grid_sample's -0.75), edges clamped, in float64.

tests/test_torch_rand_augment.py holds each op against the JAX module's
Pillow output with the tolerance it measured.  Host-side only: the video
dataset runs these in its loader's worker processes, on CPU tensors.
"""
from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence

import numpy as np
import torch

_MAX_LEVEL = 10.0
_FILL = (128, 128, 128)

# Pillow's resample ids, as the JAX module passes them
BILINEAR, BICUBIC = 2, 3
_RANDOM_INTERPOLATION = (BILINEAR, BICUBIC)

_HPARAMS_DEFAULT = {"translate_const": 250, "img_mean": _FILL}


# ------------------------------------------------------------ lookup tables
def _apply_lut(frames: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """frames (T, H, W, C) uint8 through per-frame, per-channel tables
    `luts` (T, C, 256) or one table (256,)."""
    if luts.dim() == 1:
        return luts.to(torch.uint8)[frames.long()]
    T, H, W, C = frames.shape
    idx = frames.long().permute(0, 3, 1, 2).reshape(T * C, H * W)
    out = torch.gather(luts.reshape(T * C, 256), 1, idx)
    return out.reshape(T, C, H, W).permute(0, 2, 3, 1).to(torch.uint8).contiguous()


def _histograms(frames: torch.Tensor) -> np.ndarray:
    """(T, C, 256) int64 per-frame, per-channel histograms."""
    T, H, W, C = frames.shape
    flat = frames.permute(0, 3, 1, 2).reshape(T * C, H * W).long()
    flat = flat + 256 * torch.arange(T * C).view(-1, 1)
    return torch.bincount(flat.reshape(-1), minlength=T * C * 256).reshape(T, C, 256).numpy()


def invert(frames, **__):
    return 255 - frames


def posterize(frames, bits_to_keep, **__):
    if bits_to_keep >= 8:
        return frames
    mask = ~(2 ** (8 - bits_to_keep) - 1)
    return _apply_lut(frames, torch.tensor([i & mask for i in range(256)]))


def solarize(frames, thresh, **__):
    return _apply_lut(frames, torch.tensor([i if i < thresh else 255 - i for i in range(256)]))


def solarize_add(frames, add, thresh=128, **__):
    # (reference: rand_augment.py:158-170) additive solarize below `thresh`
    return _apply_lut(frames, torch.tensor([min(255, i + add) if i < thresh else i
                                            for i in range(256)]))


def _auto_contrast_lut(h: np.ndarray) -> List[int]:
    """ImageOps.autocontrast's table of one channel's histogram (cutoff 0)."""
    nz = np.flatnonzero(h)
    lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (0, 0)
    if hi <= lo:
        return list(range(256))
    scale = 255.0 / (hi - lo)
    offset = -lo * scale
    return [min(255, max(0, int(ix * scale + offset))) for ix in range(256)]


def _equalize_lut(h: np.ndarray) -> List[int]:
    """ImageOps.equalize's table of one channel's histogram (Pillow clips
    its entries to a byte)."""
    histo = [int(f) for f in h if f]
    if len(histo) <= 1:
        return list(range(256))
    step = (sum(histo) - histo[-1]) // 255
    if not step:
        return list(range(256))
    lut, n = [], step // 2
    for i in range(256):
        lut.append(min(255, n // step))
        n += int(h[i])
    return lut


def _per_channel_luts(frames, make) -> torch.Tensor:
    hist = _histograms(frames)
    return torch.tensor([[make(hc) for hc in ht] for ht in hist], dtype=torch.int64)


def auto_contrast(frames, **__):
    return _apply_lut(frames, _per_channel_luts(frames, _auto_contrast_lut))


def equalize(frames, **__):
    return _apply_lut(frames, _per_channel_luts(frames, _equalize_lut))


# ------------------------------------------------------------------- blends
def _blend(degenerate: torch.Tensor, frames: torch.Tensor, factor: float) -> torch.Tensor:
    """Pillow's ImagingBlend: in1 + alpha * (in2 - in1) in float32,
    clipped to [0, 255] and truncated."""
    a = degenerate.float()
    diff = frames.float() - a
    out = a + diff * torch.tensor(factor, dtype=torch.float32)
    return out.clamp(0.0, 255.0).to(torch.uint8)


def _luma(frames: torch.Tensor) -> torch.Tensor:
    """(T, H, W) Pillow's RGB -> L: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    x = frames.to(torch.int64)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16)


def brightness(frames, factor, **__):
    return _blend(torch.zeros_like(frames), frames, factor)


def color(frames, factor, **__):
    grey = _luma(frames).to(torch.uint8)[..., None].expand_as(frames)
    return _blend(grey, frames, factor)


def contrast(frames, factor, **__):
    # ImageStat's mean of L from its histogram, rounded half up, per frame
    lum = _luma(frames)
    T = lum.shape[0]
    hist = torch.bincount((lum + 256 * torch.arange(T).view(T, 1, 1)).reshape(-1),
                          minlength=256 * T).reshape(T, 256).numpy()
    means = [int(float((h * np.arange(256)).sum()) / float(h.sum()) + 0.5) for h in hist]
    degenerate = torch.tensor(means, dtype=torch.uint8).view(T, 1, 1, 1).expand_as(frames)
    return _blend(degenerate, frames, factor)


_SMOOTH = np.float32([1, 1, 1, 1, 5, 1, 1, 1, 1]) / np.float32(13)


def _smooth(frames: torch.Tensor) -> torch.Tensor:
    """ImageFilter.SMOOTH: the 3x3 kernel in float32, summed row by row as
    Pillow's ImagingFilter3x3, rounded half up; the border rows and
    columns keep their pixels."""
    x = frames.float()
    k = torch.from_numpy(_SMOOTH)
    H, W = x.shape[1:3]
    if H < 3 or W < 3:
        return frames.clone()

    def row(r, k0):  # one input row's three taps, as KERNEL1x3
        return (x[:, r, 0:W - 2] * k[k0] + x[:, r, 1:W - 1] * k[k0 + 1]) + x[:, r, 2:W] * k[k0 + 2]

    lo, mid, hi = slice(2, H), slice(1, H - 1), slice(0, H - 2)
    ss = torch.zeros_like(x[:, 1:H - 1, 1:W - 1])
    ss = ss + row(lo, 0)
    ss = ss + row(mid, 3)
    ss = ss + row(hi, 6)
    out = frames.clone()
    inner = torch.where(ss <= 0, torch.zeros_like(ss),
                        torch.where(ss >= 255, torch.full_like(ss, 255), ss + 0.5))
    out[:, 1:H - 1, 1:W - 1] = inner.to(torch.uint8)
    return out


def sharpness(frames, factor, **__):
    return _blend(_smooth(frames), frames, factor)


# ------------------------------------------------------------------- affine
def _cubic(v0, v1, v2, v3, d):
    """Pillow's BICUBIC macro: cubic convolution with a = -1."""
    p2 = v2 - v0
    p3 = 2 * (v0 - v1) + v2 - v3
    p4 = -v0 + v1 - v2 + v3
    return v1 + d * (p2 + d * (p3 + d * p4))


def affine(frames: torch.Tensor, matrix, resample: int, fill) -> torch.Tensor:
    """Pillow's Image.transform(size, AFFINE, matrix): output pixel (x, y)
    reads the input at (a (x + .5) + b (y + .5) + c, d (x + .5) + e (y + .5)
    + f), filled with `fill` outside [0, W) x [0, H), else sampled at that
    point less half a pixel, edges clamped, in float64; bilinear values are
    truncated and bicubic ones clipped and truncated to bytes."""
    T, H, W, C = frames.shape
    a, b, c, d, e, f = (float(v) for v in matrix)
    xs = torch.arange(W, dtype=torch.float64) + 0.5
    ys = torch.arange(H, dtype=torch.float64) + 0.5
    xin = a * xs[None, :] + b * ys[:, None] + c
    yin = d * xs[None, :] + e * ys[:, None] + f
    inside = (xin >= 0) & (xin < W) & (yin >= 0) & (yin < H)
    xin, yin = xin - 0.5, yin - 0.5
    x0, y0 = torch.floor(xin), torch.floor(yin)
    dx, dy = (xin - x0)[None, ..., None], (yin - y0)[None, ..., None]
    x0, y0 = x0.long(), y0.long()
    src = frames.to(torch.float64)

    def at(yy, xx):
        return src[:, yy.clamp(0, H - 1), xx.clamp(0, W - 1)]

    if resample == BILINEAR:
        top = at(y0, x0) + (at(y0, x0 + 1) - at(y0, x0)) * dx
        bot = at(y0 + 1, x0) + (at(y0 + 1, x0 + 1) - at(y0 + 1, x0)) * dx
        val = (top + (bot - top) * dy).clamp(0.0, 255.0)
    elif resample == BICUBIC:
        rows = [_cubic(*(at(y0 + j, x0 + i) for i in (-1, 0, 1, 2)), dx) for j in (-1, 0, 1, 2)]
        val = _cubic(*rows, dy).clamp(0.0, 255.0)
    else:
        raise ValueError(f"resample {resample}: bilinear ({BILINEAR}) or bicubic ({BICUBIC})")
    fill_t = torch.tensor([float(v) for v in fill], dtype=torch.float64)[:C]
    out = torch.where(inside[None, ..., None], val, fill_t)
    return out.to(torch.uint8)


def shear_x(frames, factor, fillcolor=_FILL, resample=BILINEAR):
    return affine(frames, (1, factor, 0, 0, 1, 0), resample, fillcolor)


def shear_y(frames, factor, fillcolor=_FILL, resample=BILINEAR):
    return affine(frames, (1, 0, 0, factor, 1, 0), resample, fillcolor)


def translate_x_rel(frames, pct, fillcolor=_FILL, resample=BILINEAR):
    return affine(frames, (1, 0, pct * frames.shape[2], 0, 1, 0), resample, fillcolor)


def translate_y_rel(frames, pct, fillcolor=_FILL, resample=BILINEAR):
    return affine(frames, (1, 0, 0, 0, 1, pct * frames.shape[1]), resample, fillcolor)


def translate_x_abs(frames, pixels, fillcolor=_FILL, resample=BILINEAR):
    return affine(frames, (1, 0, pixels, 0, 1, 0), resample, fillcolor)


def translate_y_abs(frames, pixels, fillcolor=_FILL, resample=BILINEAR):
    return affine(frames, (1, 0, 0, 0, 1, pixels), resample, fillcolor)


def rotate(frames, degrees, fillcolor=_FILL, resample=BILINEAR):
    """Image.rotate about the centre, same size: its fast paths (0, 180,
    and 90 / 270 on a square) and its rounded inverse matrix."""
    angle = degrees % 360.0
    H, W = frames.shape[1:3]
    if angle == 0:
        return frames.clone()
    if angle == 180:
        return frames.flip(1, 2)
    if angle in (90, 270) and W == H:
        return torch.rot90(frames, 1 if angle == 90 else -1, (1, 2))
    cx, cy = W / 2, H / 2
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy + m[2] + cx
    m[5] = m[3] * -cx + m[4] * -cy + m[5] + cy
    return affine(frames, m, resample, fillcolor)


# ------------------------------------------------- magnitude -> argument maps
# (reference: rand_augment.py:195-278, identical ranges)

def _randomly_negate(v, rng):
    return -v if rng.random() > 0.5 else v


def _rotate_level(level, _hp, rng):
    return (_randomly_negate((level / _MAX_LEVEL) * 30.0, rng),)


def _enhance_level(level, _hp, rng):
    return ((level / _MAX_LEVEL) * 1.8 + 0.1,)


def _enhance_increasing_level(level, _hp, rng):
    return (1.0 + _randomly_negate((level / _MAX_LEVEL) * 0.9, rng),)


def _shear_level(level, _hp, rng):
    return (_randomly_negate((level / _MAX_LEVEL) * 0.3, rng),)


def _translate_abs_level(level, hp, rng):
    return (_randomly_negate((level / _MAX_LEVEL) * float(hp["translate_const"]), rng),)


def _translate_rel_level(level, hp, rng):
    pct = hp.get("translate_pct", 0.45)
    return (_randomly_negate((level / _MAX_LEVEL) * pct, rng),)


def _posterize_level(level, _hp, rng):
    return (int((level / _MAX_LEVEL) * 4),)


def _posterize_increasing_level(level, hp, rng):
    return (4 - _posterize_level(level, hp, rng)[0],)


def _posterize_original_level(level, _hp, rng):
    return (int((level / _MAX_LEVEL) * 4) + 4,)


def _solarize_level(level, _hp, rng):
    return (int((level / _MAX_LEVEL) * 256),)


def _solarize_increasing_level(level, hp, rng):
    return (256 - _solarize_level(level, hp, rng)[0],)


def _solarize_add_level(level, _hp, rng):
    return (int((level / _MAX_LEVEL) * 110),)


LEVEL_TO_ARG = {
    "AutoContrast": None, "Equalize": None, "Invert": None,
    "Rotate": _rotate_level,
    "Posterize": _posterize_level,
    "PosterizeIncreasing": _posterize_increasing_level,
    "PosterizeOriginal": _posterize_original_level,
    "Solarize": _solarize_level,
    "SolarizeIncreasing": _solarize_increasing_level,
    "SolarizeAdd": _solarize_add_level,
    "Color": _enhance_level, "ColorIncreasing": _enhance_increasing_level,
    "Contrast": _enhance_level,
    "ContrastIncreasing": _enhance_increasing_level,
    "Brightness": _enhance_level,
    "BrightnessIncreasing": _enhance_increasing_level,
    "Sharpness": _enhance_level,
    "SharpnessIncreasing": _enhance_increasing_level,
    "ShearX": _shear_level, "ShearY": _shear_level,
    "TranslateX": _translate_abs_level, "TranslateY": _translate_abs_level,
    "TranslateXRel": _translate_rel_level,
    "TranslateYRel": _translate_rel_level,
}

NAME_TO_OP = {
    "AutoContrast": auto_contrast, "Equalize": equalize, "Invert": invert,
    "Rotate": rotate,
    "Posterize": posterize, "PosterizeIncreasing": posterize,
    "PosterizeOriginal": posterize,
    "Solarize": solarize, "SolarizeIncreasing": solarize,
    "SolarizeAdd": solarize_add,
    "Color": color, "ColorIncreasing": color,
    "Contrast": contrast, "ContrastIncreasing": contrast,
    "Brightness": brightness, "BrightnessIncreasing": brightness,
    "Sharpness": sharpness, "SharpnessIncreasing": sharpness,
    "ShearX": shear_x, "ShearY": shear_y,
    "TranslateX": translate_x_abs, "TranslateY": translate_y_abs,
    "TranslateXRel": translate_x_rel, "TranslateYRel": translate_y_rel,
}

_RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness", "ShearX",
    "ShearY", "TranslateXRel", "TranslateYRel"]

_RAND_INCREASING_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing",
    "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel"]

# (reference: rand_augment.py:425-441)
_RAND_CHOICE_WEIGHTS_0 = {
    "Rotate": 0.3, "ShearX": 0.2, "ShearY": 0.2, "TranslateXRel": 0.1,
    "TranslateYRel": 0.1, "Color": 0.025, "Sharpness": 0.025,
    "AutoContrast": 0.025, "Solarize": 0.005, "SolarizeAdd": 0.005,
    "Contrast": 0.005, "Brightness": 0.005, "Equalize": 0.005,
    "Posterize": 0, "Invert": 0}


def _as_frames(x) -> torch.Tensor:
    """(T, H, W, C) uint8 CPU tensor of an (H, W, C) or (T, H, W, C) array."""
    t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)
    if t.dtype != torch.uint8:
        raise ValueError(f"RandAugment takes uint8 pixels, got {t.dtype}")
    if t.device.type != "cpu":
        raise ValueError("RandAugment runs on the host: pass CPU pixels")
    return t[None] if t.dim() == 3 else t


class AugmentOp:
    """One named op at a magnitude, applied with probability `prob` to a
    frame or a clip: a clip's frames share one parameter draw per call, so
    it stays temporally consistent (reference: rand_augment.py:337-382)."""

    def __init__(self, name: str, prob: float = 0.5, magnitude: float = 10,
                 hparams: Optional[dict] = None):
        hparams = hparams or _HPARAMS_DEFAULT
        self.name = name
        self.aug_fn = NAME_TO_OP[name]
        self.level_fn = LEVEL_TO_ARG[name]
        self.prob = prob
        self.magnitude = magnitude
        self.hparams = dict(hparams)
        self.fillcolor = tuple(int(c) for c in hparams.get("img_mean", _FILL))
        self.resample = hparams.get("interpolation", _RANDOM_INTERPOLATION)
        self.magnitude_std = self.hparams.get("magnitude_std", 0)

    def __call__(self, frames: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
        """frames: (T, H, W, C) uint8 tensor."""
        if self.prob < 1.0 and rng.random() > self.prob:
            return frames
        magnitude = self.magnitude
        if self.magnitude_std and self.magnitude_std > 0:
            magnitude = rng.normal(magnitude, self.magnitude_std)
        magnitude = min(_MAX_LEVEL, max(0.0, magnitude))
        args = self.level_fn(magnitude, self.hparams, rng) if self.level_fn is not None else ()
        resample = self.resample
        if isinstance(resample, (list, tuple)):
            resample = resample[rng.integers(len(resample))]
        return self.aug_fn(frames, *args, fillcolor=self.fillcolor, resample=resample)


class RandAugment:
    """Pick `num_layers` ops per call and apply them in sequence
    (reference: rand_augment.py:462-478).  Takes an (H, W, C) frame or a
    (T, H, W, C) clip of uint8 (numpy or a CPU tensor) and returns a uint8
    numpy array of the same shape."""

    def __init__(self, ops: Sequence[AugmentOp], num_layers: int = 2,
                 choice_weights=None, rng: Optional[np.random.Generator] = None):
        self.ops = list(ops)
        self.num_layers = num_layers
        self.choice_weights = choice_weights
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or self.rng
        single = frames.ndim == 3
        work = _as_frames(frames)
        chosen = rng.choice(len(self.ops), self.num_layers,
                            replace=self.choice_weights is None, p=self.choice_weights)
        for i in chosen:
            work = self.ops[int(i)](work, rng)
        out = work.numpy()
        return out[0] if single else out


def rand_augment_ops(magnitude: float = 10, hparams: Optional[dict] = None,
                     transforms: Optional[Sequence[str]] = None):
    hparams = hparams or _HPARAMS_DEFAULT
    transforms = transforms or _RAND_TRANSFORMS
    return [AugmentOp(name, prob=0.5, magnitude=magnitude, hparams=hparams)
            for name in transforms]


def rand_augment_transform(config_str: str, hparams: Optional[dict] = None,
                           rng: Optional[np.random.Generator] = None) -> RandAugment:
    """RandAugment from a timm config string, e.g. 'rand-m9-n3-mstd0.5' or
    'rand-m7-inc1' (reference: rand_augment.py:481-530; grammar:
    m=magnitude, n=num layers, w=weight index, mstd=magnitude noise std,
    inc=use severity-increasing op variants)."""
    hparams = dict(hparams or _HPARAMS_DEFAULT)
    magnitude = _MAX_LEVEL
    num_layers = 2
    weight_idx = None
    transforms = _RAND_TRANSFORMS
    config = config_str.split("-")
    if config[0] != "rand":
        raise ValueError(f"unsupported augment spec: {config_str}")
    for c in config[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == "mstd":
            hparams.setdefault("magnitude_std", float(val))
        elif key == "inc":
            if bool(int(val)):
                transforms = _RAND_INCREASING_TRANSFORMS
        elif key == "m":
            magnitude = int(val)
        elif key == "n":
            num_layers = int(val)
        elif key == "w":
            weight_idx = int(val)
        else:
            raise ValueError(f"unknown RandAugment key {key!r}")
    ops = rand_augment_ops(magnitude=magnitude, hparams=hparams, transforms=transforms)
    choice_weights = None
    if weight_idx is not None:
        if weight_idx != 0:
            raise ValueError("only weight set 0 exists")
        probs = np.array([_RAND_CHOICE_WEIGHTS_0[k] for k in transforms], dtype=np.float64)
        choice_weights = probs / probs.sum()
    return RandAugment(ops, num_layers, choice_weights=choice_weights, rng=rng)


# ----------------------------------------------------------- random erasing
class RandomErasing:
    """Erase random rectangles from a normalized image or video
    (reference: random_erasing.py:27-175; 'Random Erasing Data
    Augmentation', Zhong et al.).

    Channels-last float arrays, (H, W, C) images or (T, H, W, C) clips,
    after normalization.  Modes: 'const' zeros, 'rand' per-channel normal
    colour, 'pixel' per-pixel normal noise.  For a clip, `cube=True`
    (the reference's default) erases the same region in every frame."""

    def __init__(self, probability: float = 0.5, min_area: float = 0.02,
                 max_area: float = 1 / 3, min_aspect: float = 0.3,
                 max_aspect: Optional[float] = None, mode: str = "const",
                 min_count: int = 1, max_count: Optional[int] = None,
                 num_splits: int = 0, cube: bool = True,
                 rng: Optional[np.random.Generator] = None):
        self.probability = probability
        self.min_area = min_area
        self.max_area = max_area
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))
        self.min_count = min_count
        self.max_count = max_count or min_count
        self.num_splits = num_splits
        self.cube = cube
        mode = (mode or "const").lower()
        if mode not in ("const", "rand", "pixel"):
            raise ValueError(f"unknown erase mode {mode!r}")
        self.mode = mode
        self.rng = rng or np.random.default_rng()

    def _fill(self, h: int, w: int, c: int, rng) -> np.ndarray:
        if self.mode == "pixel":
            return rng.normal(size=(h, w, c)).astype(np.float32)
        if self.mode == "rand":
            return np.broadcast_to(rng.normal(size=(1, 1, c)).astype(np.float32), (h, w, c))
        return np.zeros((h, w, c), np.float32)

    def _boxes(self, img_h: int, img_w: int, rng) -> List[tuple]:
        if rng.random() > self.probability:
            return []
        area = img_h * img_w
        count = (self.min_count if self.min_count == self.max_count
                 else int(rng.integers(self.min_count, self.max_count + 1)))
        boxes = []
        for _ in range(count):
            for _ in range(10):
                target = rng.uniform(self.min_area, self.max_area) * area / count
                aspect = math.exp(rng.uniform(*self.log_aspect_ratio))
                h = int(round(math.sqrt(target * aspect)))
                w = int(round(math.sqrt(target / aspect)))
                if w < img_w and h < img_h:
                    top = int(rng.integers(0, img_h - h + 1))
                    left = int(rng.integers(0, img_w - w + 1))
                    boxes.append((top, left, h, w))
                    break
        return boxes

    def __call__(self, x: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or self.rng
        x = np.array(x, dtype=np.float32, copy=True)
        if x.ndim == 3:  # (H, W, C)
            for top, left, h, w in self._boxes(x.shape[0], x.shape[1], rng):
                x[top:top + h, left:left + w] = self._fill(h, w, x.shape[-1], rng)
            return x
        if x.ndim != 4:
            raise ValueError(f"expected (H,W,C) or (T,H,W,C), got {x.shape}")
        t, img_h, img_w, c = x.shape
        start = t // self.num_splits if self.num_splits > 1 else 0
        if self.cube:
            for top, left, h, w in self._boxes(img_h, img_w, rng):
                x[start:, top:top + h, left:left + w] = self._fill(h, w, c, rng)
        else:
            for i in range(start, t):
                for top, left, h, w in self._boxes(img_h, img_w, rng):
                    x[i, top:top + h, left:left + w] = self._fill(h, w, c, rng)
        return x


def create_random_augment(input_size, auto_augment: Optional[str] = None,
                          interpolation: str = "bilinear",
                          rng: Optional[np.random.Generator] = None) -> Optional[RandAugment]:
    """Video-clip RandAugment factory (reference: video_transforms.py:656-693):
    translate_const scales with the crop size; the fill colour is the
    ImageNet mean."""
    if not auto_augment:
        return None
    if not auto_augment.startswith("rand"):
        raise NotImplementedError(
            f"augment scheme {auto_augment!r}: only RandAugment ('rand-...') is supported; the "
            "reference's autoaugment/augmix variants are unused in every shipped config")
    size = min(input_size) if isinstance(input_size, (tuple, list)) else int(input_size)
    hparams = {"translate_const": int(size * 0.45),
               "img_mean": tuple(int(255 * m) for m in (0.485, 0.456, 0.406)),
               "interpolation": (BICUBIC if interpolation == "bicubic"
                                 else _RANDOM_INTERPOLATION if interpolation == "random"
                                 else BILINEAR)}
    return rand_augment_transform(auto_augment, hparams, rng=rng)
