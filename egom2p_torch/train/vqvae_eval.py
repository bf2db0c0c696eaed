"""The VQ-VAE tokenizer trainer's evaluation: reconstruction loss and the cam
/ gaze metric suite, on the live weights and on their EMA.

Port of egom2p_tpu/train/vqvae_eval.py (reference: run_training_vqvae.py:
1296-1757) for the cam and gaze domains:

  * `evaluate_loss`: the mean reconstruction loss over the eval set (the
    commitment term is a training loss; eval tracks reconstruction);
  * `eval_metrics`: cam (MSE, MAE of the translation, PSNR and the geodesic
    rotation error in degrees, on denormalized 9D trajectories) or gaze
    (MSE / MAE / PSNR over the valid frames of the denormalized points),
    plus the codebook usage over windows of 256 samples' tokens; on the
    port's numpy copies core/metrics.py and data/cam_gaze.py;
  * `run_eval_suite`: both on the live weights, then the metric suite again
    on the EMA weights (`ema_` keys) when the trainer keeps an EMA.

Under a process group (the data-parallel trainer) rank 0 evaluates the
whole eval set alone and every rank returns its results (one broadcast):
the same metrics as one process, on weights every rank holds alike.  The
metrics are not sums a reduction could split (PSNR, rotation errors,
codebook usage over windows).  Not ported yet: the video and feature
domains (MS-SSIM, FID, LPIPS, Inception score).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from egom2p_torch.core import metrics as M
from egom2p_torch.data.cam_gaze import denormalize_cam, denormalize_gaze
from egom2p_torch.tokenizers.seq_vqvae import SeqTokenizer
from egom2p_torch.train.vqvae_train import reconst_loss

SEQ_DOMAINS = ("cam", "gaze")


def _batches_of(data, batch_size: int, limit: Optional[int] = None):
    """Numpy batches of an (N, ...) array or an indexable dataset."""
    n = len(data) if limit is None else min(len(data), limit)
    if isinstance(data, np.ndarray):
        for i in range(0, n, batch_size):
            yield data[i:i + batch_size]
        return
    for i in range(0, n, batch_size):
        yield np.stack([data[j] for j in range(i, min(i + batch_size, n))])


def _autoencode_and_tokens(tok: SeqTokenizer, batch: np.ndarray):
    """Reconstruction and tokens of a batch, as numpy."""
    return tok.autoencode(batch).cpu().numpy(), tok.tokenize(batch).cpu().numpy()


def evaluate_loss(tok: SeqTokenizer, data, loss_fn: str, codebook_weight: float,
                  batch_size: int, n_channels: int, limit: Optional[int] = None) -> Dict[str, float]:
    """Mean eval losses (egom2p_tpu/train/vqvae_eval.py:evaluate_loss;
    reference `evaluate`, run_training_vqvae.py:1421-1504): eval_loss is the
    reconstruction loss, as there."""
    total, count = 0.0, 0
    for batch in _batches_of(data, batch_size, limit):
        rec, _ = _autoencode_and_tokens(tok, batch)
        r = float(reconst_loss(torch.from_numpy(rec), torch.from_numpy(np.asarray(batch)),
                               loss_fn, n_channels))
        total += r * len(batch)
        count += len(batch)
    if count == 0:
        return {}
    return {"eval_loss": total / count, "eval_reconst_loss": total / count}


def _cam_metrics(pred, gt) -> Dict[str, float]:
    """Denormalized 9D trajectory metrics (reference :1653-1663)."""
    p, g = denormalize_cam(pred), denormalize_cam(gt)
    return {"mse": M.mse(p, g), "mae_transl": M.mae(p[..., 6:], g[..., 6:]),
            "psnr": M.psnr(p, g, data_range=2.0), "cam_rot_deg": M.rotation_distance_deg(p, g)}


def _gaze_metrics(pred, gt) -> Dict[str, float]:
    """Gaze metrics over the valid frames: gt carries (x, y, valid), pred
    (x, y) (reference :1664-1672)."""
    mask = gt[..., 2] > 0.5
    if mask.sum() == 0:  # keep the key set stable across epochs
        return {"mse": 0.0, "mae": 0.0, "psnr": 0.0}
    pm, gm = denormalize_gaze(pred[..., :2])[mask], denormalize_gaze(gt[..., :2])[mask]
    return {"mse": M.mse(pm, gm), "mae": M.mae(pm, gm), "psnr": M.psnr(pm, gm, data_range=1.0)}


def eval_metrics(tok: SeqTokenizer, data, domain: str, codebook_size: int, batch_size: int,
                 limit: Optional[int] = None) -> Dict[str, float]:
    """The cam or gaze metric suite (egom2p_tpu/train/vqvae_eval.py:
    eval_metrics; reference: run_training_vqvae.py:1507-1757) under the
    tokenizer's current weights."""
    if domain not in SEQ_DOMAINS:
        raise NotImplementedError(f"eval domain {domain!r}: the video and feature domains' "
                                  "metrics are not ported (ROADMAP Queue 1 item 9)")
    preds, gts, all_tokens = [], [], []
    for batch in _batches_of(data, batch_size, limit):
        rec, tokens = _autoencode_and_tokens(tok, batch)
        preds.append(rec)
        gts.append(batch)
        all_tokens.append(tokens.reshape(len(batch), -1))
    if not preds:
        return {}
    pred, gt, tokens = np.concatenate(preds), np.concatenate(gts), np.concatenate(all_tokens)
    results = _cam_metrics(pred, gt) if domain == "cam" else _gaze_metrics(pred, gt)
    # codebook usage over 256-sample windows (reference :1711-1719)
    results["codebook_usage"] = M.codebook_usage(tokens, codebook_size,
                                                 window=256 * tokens.shape[1])
    return results


@contextlib.contextmanager
def swapped_params(net: torch.nn.Module, params: Dict[str, torch.Tensor]):
    """`net` with `params` in place of its parameters (the codebook buffers
    stay), restored bitwise after."""
    live = dict(net.named_parameters())
    with torch.no_grad():
        saved = {n: p.detach().clone() for n, p in live.items()}
        for n, p in live.items():
            p.copy_(params[n])
    try:
        yield net
    finally:
        with torch.no_grad():
            for n, p in live.items():
                p.copy_(saved[n])


def run_eval_suite(tok: SeqTokenizer, data, domain: str, codebook_size: int, loss_fn: str,
                   codebook_weight: float, batch_size: int, limit: Optional[int] = None,
                   ema: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, float]:
    """The `eval_during_training` analog (egom2p_tpu/train/vqvae_eval.py:
    run_eval_suite; reference :1296-1419): the loss and the metric suite on
    the live weights, then the metric suite on the EMA weights (with the
    live codebook) as `ema_` keys when `ema` is given.  Under a process
    group rank 0 computes them and every rank returns them (the module
    docstring)."""
    from egom2p_torch.core import distributed
    results = None
    if distributed.is_main_process():
        results = _eval_suite(tok, data, domain, codebook_size, loss_fn, codebook_weight,
                              batch_size, limit, ema)
    return distributed.broadcast_object(results)


def _eval_suite(tok, data, domain, codebook_size, loss_fn, codebook_weight, batch_size,
                limit, ema) -> Dict[str, float]:
    n_channels = tok.net.encoder.in_channels
    out = dict(evaluate_loss(tok, data, loss_fn, codebook_weight, batch_size, n_channels, limit))
    out.update(eval_metrics(tok, data, domain, codebook_size, batch_size, limit))
    if ema is not None:
        with swapped_params(tok.net, ema):
            ema_out = eval_metrics(tok, data, domain, codebook_size, batch_size, limit)
        out.update({f"ema_{k}": v for k, v in ema_out.items()})
    return out
