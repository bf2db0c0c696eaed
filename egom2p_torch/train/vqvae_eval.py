"""The VQ-VAE tokenizer trainer's evaluation: reconstruction loss and the
per-domain metric suite, on the live weights and on their EMA.

Port of egom2p_tpu/train/vqvae_eval.py (reference: run_training_vqvae.py:
1296-1757):

  * `evaluate_loss`: the mean reconstruction loss over the eval set (the
    commitment term is a training loss; eval tracks reconstruction);
  * `eval_metrics`: cam (MSE, MAE of the translation, PSNR and the geodesic
    rotation error in degrees, on denormalized 9D trajectories), gaze
    (MSE / MAE / PSNR over the valid frames of the denormalized points), the
    teacher-feature domains (MSE / MAE / PSNR at data range 1, as the
    reference's DENSE_FEAT_MODALITIES), or rgb / depth clips streamed batch
    by batch (`_video_metrics_stream`: MSE / MAE / PSNR, and for rgb in
    [0, 1] per frame MS-SSIM, LPIPS, FID and the Inception score where
    their weight files are in EGOM2P_CKPT_DIR, core/image_metrics.py; depth
    on the standardized channel), plus the codebook usage over windows of
    256 samples' tokens; on the port's numpy copies core/metrics.py and
    data/cam_gaze.py;
  * `run_eval_suite`: both on the live weights, then the metric suite again
    on the EMA weights (`ema_` keys) when the trainer keeps an EMA.

Under a process group (the data-parallel trainer) rank 0 evaluates the
whole eval set alone and every rank returns its results (one broadcast):
the same metrics as one process, on weights every rank holds alike.  The
metrics are not sums a reduction could split (PSNR, rotation errors,
codebook usage over windows).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from egom2p_torch.core import metrics as M
from egom2p_torch.data.cam_gaze import denormalize_cam, denormalize_gaze
from egom2p_torch.tokenizers.seq_vqvae import VQTokenizer
from egom2p_torch.train.vqvae_train import reconst_loss

SEQ_DOMAINS = ("cam", "gaze")
VIDEO_DOMAINS = ("rgb", "depth")


def _batches_of(data, batch_size: int, limit: Optional[int] = None):
    """Numpy batches of an (N, ...) array or an indexable dataset."""
    n = len(data) if limit is None else min(len(data), limit)
    if isinstance(data, np.ndarray):
        for i in range(0, n, batch_size):
            yield data[i:i + batch_size]
        return
    for i in range(0, n, batch_size):
        yield np.stack([data[j] for j in range(i, min(i + batch_size, n))])


def _autoencode_and_tokens(tok: VQTokenizer, batch: np.ndarray):
    """Reconstruction and tokens of a batch, as numpy."""
    return tok.autoencode(batch).cpu().numpy(), tok.tokenize(batch).cpu().numpy()


def evaluate_loss(tok: VQTokenizer, data, loss_fn: str, codebook_weight: float,
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


def eval_metrics(tok: VQTokenizer, data, domain: str, codebook_size: int, batch_size: int,
                 limit: Optional[int] = None, no_inception: bool = False) -> Dict[str, float]:
    """The domain's metric suite (egom2p_tpu/train/vqvae_eval.py:
    eval_metrics; reference: run_training_vqvae.py:1507-1757) under the
    tokenizer's current weights."""
    if domain in VIDEO_DOMAINS:
        # clips are large: batches stream into sums and feature lists
        # (reference :1598-1652, torchmetrics' update())
        return _video_metrics_stream(tok, data, domain, batch_size, limit, no_inception,
                                     codebook_size) or {}
    from egom2p_torch.models.teachers import TEACHER_SPECS
    if domain not in SEQ_DOMAINS and domain not in TEACHER_SPECS:
        raise ValueError(f"unknown eval domain {domain!r}")
    preds, gts, all_tokens = [], [], []
    for batch in _batches_of(data, batch_size, limit):
        rec, tokens = _autoencode_and_tokens(tok, batch)
        preds.append(rec)
        gts.append(batch)
        all_tokens.append(tokens.reshape(len(batch), -1))
    if not preds:
        return {}
    pred, gt, tokens = np.concatenate(preds), np.concatenate(gts), np.concatenate(all_tokens)
    if domain == "cam":
        results = _cam_metrics(pred, gt)
    elif domain == "gaze":
        results = _gaze_metrics(pred, gt)
    else:
        # feature domains: the three metrics the reference builds for
        # DENSE_FEAT_MODALITIES (run_training_vqvae.py:1546-1562, data_range 1)
        results = {"mse": M.mse(pred, gt), "mae": M.mae(pred, gt),
                   "psnr": M.psnr(pred, gt, data_range=1.0)}
    # codebook usage over 256-sample windows (reference :1711-1719)
    results["codebook_usage"] = M.codebook_usage(tokens, codebook_size,
                                                 window=256 * tokens.shape[1])
    return results


def _video_metrics_stream(tok: VQTokenizer, data, domain: str, batch_size: int, limit,
                          no_inception: bool, codebook_size: int) -> Optional[Dict[str, float]]:
    """rgb / depth metrics over streamed batches (egom2p_tpu/train/
    vqvae_eval.py:_video_metrics_stream): MSE / MAE sums (PSNR from the
    global MSE), per-frame MS-SSIM and LPIPS means, and one InceptionV3
    forward per split feeding FID and IS.  rgb in [0, 1] per frame
    (reference :1598-1652), depth on the standardized channel (:1604-1608).
    LPIPS and Inception run on the tokenizer's device where their weight
    files exist, and are left out where they do not."""
    from egom2p_torch.core.image_metrics import (MissingPretrainedWeights, fid_from_features,
                                                 get_inception_fns, get_lpips,
                                                 inception_score_from_probs, ms_ssim)

    lpips = inception = None
    if domain == "rgb":
        try:
            lpips = get_lpips(tok.device)
        except MissingPretrainedWeights:
            pass
        try:
            inception = get_inception_fns(tok.device)
        except MissingPretrainedWeights:
            pass
    data_range = 1.0 if domain == "rgb" else 2.0
    sq = ab = n_el = 0.0
    ssim_sum = lpips_sum = frames_n = 0.0
    feats_r, feats_f, probs_f, tokens_list = [], [], [], []
    ssim_ok = True
    for batch in _batches_of(data, batch_size, limit):
        rec, tokens = _autoencode_and_tokens(tok, batch)
        tokens_list.append(tokens.reshape(len(batch), -1))
        if domain == "rgb":
            # [-1, 1] -> [0, 1] (reference denormalize mean / std 0.5, :1599-1601)
            p, g = np.clip(rec * 0.5 + 0.5, 0.0, 1.0), batch * 0.5 + 0.5
        else:
            p, g = rec, batch
        diff = p - g
        sq += float(np.sum(diff ** 2))
        ab += float(np.sum(np.abs(diff)))
        n_el += diff.size
        if domain == "rgb":
            fp = p.reshape(-1, *p.shape[-3:])  # (B*T, H, W, C) frames
            fg = g.reshape(-1, *g.shape[-3:])
            ssim_ok = min(fp.shape[-3:-1]) >= 176  # the 5-scale minimum side
            if ssim_ok:
                ssim_sum += ms_ssim(fp, fg, data_range=1.0) * len(fp)
            if lpips is not None:
                lpips_sum += lpips(fp * 2 - 1, fg * 2 - 1) * len(fp)
            if inception is not None:
                feature_fn, _, run = inception
                f, pr = run(fp)  # one forward feeds FID's fake side and IS
                feats_f.append(f)
                probs_f.append(pr)
                feats_r.append(feature_fn(fg))
            frames_n += len(fp)
    if not tokens_list:
        return None
    m = sq / n_el
    out = {"mse": m, "mae": ab / n_el,
           "psnr": float("inf") if m == 0 else float(10 * np.log10(data_range ** 2 / m))}
    if domain == "rgb" and frames_n:
        if ssim_ok:
            out["ms_ssim"] = ssim_sum / frames_n
        if lpips is not None:
            out["lpips"] = lpips_sum / frames_n
        if inception is not None:
            out["fid"] = fid_from_features(np.concatenate(feats_r), np.concatenate(feats_f))
            if not no_inception:
                out["inception_score"] = inception_score_from_probs(np.concatenate(probs_f))
    tokens = np.concatenate(tokens_list)
    out["codebook_usage"] = M.codebook_usage(tokens, codebook_size, window=256 * tokens.shape[1])
    return out


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


def run_eval_suite(tok: VQTokenizer, data, domain: str, codebook_size: int, loss_fn: str,
                   codebook_weight: float, batch_size: int, limit: Optional[int] = None,
                   ema: Optional[Dict[str, torch.Tensor]] = None,
                   no_inception: bool = False) -> Dict[str, float]:
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
                              batch_size, limit, ema, no_inception)
    return distributed.broadcast_object(results)


def _eval_suite(tok, data, domain, codebook_size, loss_fn, codebook_weight, batch_size,
                limit, ema, no_inception) -> Dict[str, float]:
    out = dict(evaluate_loss(tok, data, loss_fn, codebook_weight, batch_size, tok.net.n_channels,
                             limit))
    out.update(eval_metrics(tok, data, domain, codebook_size, batch_size, limit, no_inception))
    if ema is not None:
        with swapped_params(tok.net, ema):
            ema_out = eval_metrics(tok, data, domain, codebook_size, batch_size, limit,
                                   no_inception)
        out.update({f"ema_{k}": v for k, v in ema_out.items()})
    return out
