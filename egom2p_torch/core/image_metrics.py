"""Perceptual and distribution image metrics of the tokenizer evaluation.

Port of egom2p_tpu/core/image_metrics.py (reference: run_training_vqvae.py:
49-53, 1507-1757, torchmetrics' MS-SSIM, FID, InceptionScore and LPIPS):

  * `ms_ssim`, `frechet_distance`, `fid_from_features`, `FIDAccumulator`,
    `inception_score_from_probs` and `lpips_from_features` are the JAX
    module's numpy math, copied;
  * the networks behind FID / IS (core/inception_v3.py) and LPIPS
    (core/vgg_features.py) read their weights from `EGOM2P_CKPT_DIR`
    (default ./ckpt, read when a metric is built): `inception_v3.npz` and
    `lpips_vgg.npz`, the JAX package's files.  A missing file raises
    MissingPretrainedWeights: nothing is downloaded, and no metric
    computes on weights it does not have.  The networks run on the
    `device` a caller names (the tokenizer's), by default the card: without
    one the helpers raise unless given device="cpu" (core/device.py);
  * `make_fid` / `make_inception_score` build the metric objects the JAX
    module's do;
  * `make_perceptual_loss` is the trainer's differentiable LPIPS (the
    `percept_loss` hook of train/vqvae_train.py).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from egom2p_torch.core.device import resolve_device
from egom2p_torch.core.metrics import ssim_components as _ssim_components

# ---------------------------------------------------------------- MS-SSIM
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _downsample2(x: np.ndarray) -> np.ndarray:
    h, w = x.shape
    x = x[: h - h % 2, : w - w % 2]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])


def ms_ssim(pred, target, data_range: float = 2.0,
            weights: Sequence[float] = _MSSSIM_WEIGHTS) -> float:
    """Multi-scale SSIM (Wang et al. 2003), averaged over batch, frames and
    channels.  pred / target: (..., H, W) or (..., H, W, C), in [-1, 1] by
    default."""
    p = np.asarray(pred, dtype=np.float64)
    t = np.asarray(target, dtype=np.float64)
    if p.shape[-1] in (1, 3):
        p, t = np.moveaxis(p, -1, 0), np.moveaxis(t, -1, 0)
    p = p.reshape(-1, *p.shape[-2:])
    t = t.reshape(-1, *t.shape[-2:])
    n_scales = len(weights)
    min_side = min(p.shape[-2:])
    assert min_side >= 11 * 2 ** (n_scales - 1), (
        f"image side {min_side} too small for {n_scales}-scale MS-SSIM")
    vals = []
    for a, b in zip(p, t):
        mcs: List[float] = []
        ssim_last = 0.0
        for s in range(n_scales):
            ssim_last, cs = _ssim_components(a, b, data_range)
            mcs.append(cs)
            if s < n_scales - 1:
                a, b = _downsample2(a), _downsample2(b)
        terms = np.clip(np.array(mcs[:-1] + [ssim_last]), 1e-8, None)
        vals.append(np.prod(terms ** np.asarray(weights)))
    return float(np.mean(vals))


# --------------------------------------------------------------------- FID
def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)): the Frechet distance
    between Gaussians (the FID formula)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        # eps * I: rank-deficient covariances (few samples against the
        # feature width) make sqrtm blow up
        offset = np.eye(sigma1.shape[0]) * 1e-6
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(feats_real: np.ndarray, feats_fake: np.ndarray) -> float:
    """FID of two (N, D) feature matrices from any extractor."""
    fr = np.asarray(feats_real, dtype=np.float64)
    ff = np.asarray(feats_fake, dtype=np.float64)
    return frechet_distance(fr.mean(0), np.cov(fr, rowvar=False),
                            ff.mean(0), np.cov(ff, rowvar=False))


class FIDAccumulator:
    """Features gathered per split, FID at compute() (torchmetrics-style;
    reference: run_training_vqvae.py:1546-1573)."""

    def __init__(self, feature_fn: Callable[[np.ndarray], np.ndarray]):
        self.feature_fn = feature_fn
        self.real: List[np.ndarray] = []
        self.fake: List[np.ndarray] = []

    def update(self, images: np.ndarray, real: bool):
        (self.real if real else self.fake).append(np.asarray(self.feature_fn(images)))

    def compute(self) -> float:
        return fid_from_features(np.concatenate(self.real), np.concatenate(self.fake))


# --------------------------------------------------------- Inception Score
def inception_score_from_probs(probs: np.ndarray, splits: int = 10) -> float:
    """exp(E_x KL(p(y|x) || p(y))), averaged over `splits` chunks of the
    (N, classes) probabilities."""
    p = np.asarray(probs, dtype=np.float64)
    p = p / p.sum(axis=1, keepdims=True)
    scores = []
    for chunk in np.array_split(p, splits):
        if len(chunk) == 0:
            continue
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = (chunk * (np.log(chunk + 1e-12) - np.log(marginal + 1e-12))).sum(1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores))


# ------------------------------------------------------------------- LPIPS
def lpips_from_features(feats_a: Sequence[np.ndarray], feats_b: Sequence[np.ndarray],
                        lin_weights: Optional[Sequence[np.ndarray]] = None) -> float:
    """LPIPS of per-layer features (B, H, W, C): channels unit-normalized,
    squared difference, the 1x1 linear weights (uniform without
    lin_weights), spatial mean, summed over layers (Zhang et al. 2018, eq. 1)."""
    total = None
    for i, (fa, fb) in enumerate(zip(feats_a, feats_b)):
        fa = np.asarray(fa, dtype=np.float64)
        fb = np.asarray(fb, dtype=np.float64)
        na = fa / (np.linalg.norm(fa, axis=-1, keepdims=True) + 1e-10)
        nb = fb / (np.linalg.norm(fb, axis=-1, keepdims=True) + 1e-10)
        d2 = (na - nb) ** 2
        w = (np.asarray(lin_weights[i], dtype=np.float64) if lin_weights is not None
             else np.full(d2.shape[-1], 1.0 / d2.shape[-1]))
        layer = (d2 * w).sum(-1).mean(axis=(1, 2))
        total = layer if total is None else total + layer
    return float(np.mean(total))


# ------------------------------------------- the networks' weight files
class MissingPretrainedWeights(RuntimeError):
    pass


def ckpt_dir() -> str:
    """Where the networks' weight files are: $EGOM2P_CKPT_DIR, else ./ckpt."""
    return os.environ.get("EGOM2P_CKPT_DIR", "./ckpt")


def _require_weights(name: str, what: str) -> str:
    full = name if os.path.isabs(name) else os.path.join(ckpt_dir(), name)
    if not os.path.exists(full):
        raise MissingPretrainedWeights(
            f"{what} needs pretrained weights at {full}: place the converted .npz there "
            "(egom2p_torch/core/image_metrics.py); nothing is downloaded.")
    return full


def _lins(wts: Dict[str, np.ndarray]) -> List[np.ndarray]:
    return [wts[k] for k in sorted(wts) if k.startswith("lin")]


def make_lpips(kind: str = "vgg", device="cuda") -> Callable[[np.ndarray, np.ndarray], float]:
    """LPIPS: VGG16 features and the learned linear weights of
    lpips_<kind>.npz (conv{i}_{w,b}, lin{i}), the network on `device`."""
    from egom2p_torch.core.vgg_features import vgg16_features

    device = resolve_device(device)
    wts = dict(np.load(_require_weights(f"lpips_{kind}.npz", "LPIPS")))
    lins = _lins(wts)

    def metric(pred: np.ndarray, target: np.ndarray) -> float:
        return lpips_from_features(vgg16_features(pred, wts, device),
                                   vgg16_features(target, wts, device), lins)

    return metric


_CACHE: Dict = {}


def _cached(name: str, what: str, device, build):
    """build() once per weight file, its modification time and device."""
    path = _require_weights(name, what)
    key = (name, os.path.abspath(path), os.path.getmtime(path), str(device))
    if key not in _CACHE:
        for k in [k for k in _CACHE if k[0] == name]:
            del _CACHE[k]
        _CACHE[key] = build(path)
    return _CACHE[key]


def get_inception_fns(device="cuda"):
    """(feature_fn, probs_fn, run) of inception_v3.npz on `device`, built
    once per file and device."""
    from egom2p_torch.core.inception_v3 import make_inception_fns
    device = resolve_device(device)
    return _cached("inception_v3.npz", "InceptionV3 (FID pool3 / InceptionScore)", device,
                   lambda path: make_inception_fns(dict(np.load(path)), device=device))


def get_lpips(device="cuda") -> Callable[[np.ndarray, np.ndarray], float]:
    """LPIPS of lpips_vgg.npz on `device`, built once per file and device."""
    device = resolve_device(device)
    return _cached("lpips_vgg.npz", "LPIPS", device, lambda path: make_lpips("vgg", device))


def make_perceptual_loss(kind: str = "lpips", device="cuda"):
    """The trainer's hook (reference: run_training_vqvae.py:560-576):
    callable(pred, target) -> a differentiable 0-d tensor, LPIPS on
    lpips_vgg.npz's network on `device` (summed over the five taps, each
    the mean over frames and positions of the weighted squared difference
    of unit-normalized features)."""
    from egom2p_torch.core.vgg_features import conv_weights, vgg16_features_torch

    if kind != "lpips":
        raise ValueError(f"unsupported percept_loss_type {kind}")
    device = resolve_device(device)
    wts = {k: np.asarray(v) for k, v in
           np.load(_require_weights("lpips_vgg.npz", "perceptual loss (LPIPS)")).items()}
    convs = conv_weights(wts, device)
    lins = [torch.as_tensor(np.asarray(w, dtype=np.float32)).to(device) for w in _lins(wts)]

    def loss(pred, target):
        total = 0.0
        for a, b, lin in zip(vgg16_features_torch(pred, convs),
                             vgg16_features_torch(target, convs), lins):
            na = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-10)
            nb = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-10)
            total = total + ((na - nb).square() * lin).sum(-1).mean()
        return total

    return loss


def register_default_perceptual_metrics(device="cuda") -> Dict[str, object]:
    """core/metrics.py's PERCEPTUAL_METRICS filled with this suite: the
    weight-free metrics, and LPIPS on `device`, which looks for its device
    and its file when called (a RuntimeError without the device, else
    MissingPretrainedWeights without the file): registering needs
    neither."""
    from egom2p_torch.core import metrics as m

    m.PERCEPTUAL_METRICS.update({
        "ms_ssim": ms_ssim,
        "fid_from_features": fid_from_features,
        "inception_score_from_probs": inception_score_from_probs,
        "lpips_from_features": lpips_from_features,
        "lpips": lambda p, t: get_lpips(device)(p, t),
    })
    return m.PERCEPTUAL_METRICS


def make_fid(feature_fn: Optional[Callable] = None, device="cuda") -> FIDAccumulator:
    """FID accumulator (egom2p_tpu/core/image_metrics.py:make_fid); the
    default extractor is inception_v3.npz's pool3 on `device`."""
    if feature_fn is None:
        feature_fn = get_inception_fns(device)[0]
    return FIDAccumulator(feature_fn)


def make_inception_score(probs_fn: Optional[Callable] = None, splits: int = 10,
                         device="cuda") -> Callable[[np.ndarray], float]:
    """The Inception score of images in [0, 1] (reference:
    run_training_vqvae.py:1574-1586, torchmetrics InceptionScore); the
    default classifier is inception_v3.npz's on `device`."""
    if probs_fn is None:
        probs_fn = get_inception_fns(device)[1]
    return lambda images: inception_score_from_probs(probs_fn(images), splits=splits)


register_default_perceptual_metrics()
