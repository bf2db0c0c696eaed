"""Evaluation metrics for tokenizer training.

A numpy copy of egom2p_tpu/core/metrics.py, so that the port never imports
the JAX package.  Replaces the reference's torchmetrics suite + VQ utilities
(reference: run_training_vqvae.py:1507-1757, egom2p/vq/vq_utils.py:18-64)
with numpy implementations: MSE/MAE/PSNR/SSIM, windowed codebook usage,
camera rotation geodesic error and masked gaze error.  FID/LPIPS/IS require
pretrained perception networks and are intentionally not reimplemented here;
hook them up via `PERCEPTUAL_METRICS` when such checkpoints are available.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

PERCEPTUAL_METRICS: Dict[str, object] = {}  # name -> callable(pred, target)


def mse(pred, target):
    return float(np.mean((np.asarray(pred) - np.asarray(target)) ** 2))


def mae(pred, target):
    return float(np.mean(np.abs(np.asarray(pred) - np.asarray(target))))


def psnr(pred, target, data_range: float = 2.0) -> float:
    """Default data_range 2.0 for [-1, 1] video."""
    m = mse(pred, target)
    if m == 0:
        return float("inf")
    return float(10 * np.log10(data_range ** 2 / m))


def _gaussian_window(size=11, sigma=1.5):
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def ssim_components(a: np.ndarray, b: np.ndarray, data_range: float):
    """Single 2-D image pair -> (mean SSIM, mean contrast-structure term).
    The shared primitive for both single-scale SSIM and MS-SSIM (Wang et
    al. 2003; the cs term feeds the multi-scale product)."""
    from scipy.signal import fftconvolve  # scipy ships with the image stack

    k = _gaussian_window()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = fftconvolve(a, k, mode="valid")
    mu_b = fftconvolve(b, k, mode="valid")
    var_a = fftconvolve(a * a, k, mode="valid") - mu_a ** 2
    var_b = fftconvolve(b * b, k, mode="valid") - mu_b ** 2
    cov = fftconvolve(a * b, k, mode="valid") - mu_a * mu_b
    cs = (2 * cov + c2) / (var_a + var_b + c2)
    s = ((2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)) * cs
    return s.mean(), cs.mean()


def ssim(pred, target, data_range: float = 2.0) -> float:
    """Per-image SSIM, averaged over batch/time/channels.
    pred/target: (..., H, W) or (..., H, W, C)."""
    p = np.asarray(pred, dtype=np.float64)
    t = np.asarray(target, dtype=np.float64)
    if p.shape[-1] in (1, 3):  # channels-last -> move to leading
        p = np.moveaxis(p, -1, 0)
        t = np.moveaxis(t, -1, 0)
    p = p.reshape(-1, *p.shape[-2:])
    t = t.reshape(-1, *t.shape[-2:])
    return float(np.mean([ssim_components(a, b, data_range)[0]
                          for a, b in zip(p, t)]))


def codebook_usage(tokens, codebook_size: int, window: Optional[int] = None) -> float:
    """Fraction of codes used, optionally over fixed-size windows
    (reference: vq_utils.py:18-46)."""
    toks = np.asarray(tokens).reshape(-1)
    if window is None or len(toks) <= window:
        return float(len(np.unique(toks)) / codebook_size)
    usages = [len(np.unique(toks[i:i + window])) / codebook_size
              for i in range(0, len(toks) - window + 1, window)]
    return float(np.mean(usages))


def rotation_distance_deg(pred_9d, target_9d) -> float:
    """Mean geodesic rotation error in degrees between 9D trajectories
    (reference: vq_utils.py:51-64)."""
    from egom2p_torch.data.cam_gaze import cam_9d_to_mat

    rp = cam_9d_to_mat(np.asarray(pred_9d))[..., :3, :3]
    rt = cam_9d_to_mat(np.asarray(target_9d))[..., :3, :3]
    rel = np.einsum("...ij,...kj->...ik", rp, rt)  # rp @ rt^T
    tr = np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return float(np.rad2deg(np.arccos(tr)).mean())


def masked_gaze_mse(pred_xy, target_xy, valid_mask) -> float:
    """(reference: run_training_vqvae.py gaze masked metrics)"""
    p = np.asarray(pred_xy)
    t = np.asarray(target_xy)
    m = np.asarray(valid_mask).astype(bool)
    if m.sum() == 0:
        return 0.0
    return float(np.mean((p[m] - t[m]) ** 2))
