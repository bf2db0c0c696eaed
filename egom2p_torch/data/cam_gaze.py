"""Camera-trajectory and gaze preprocessing + trajectory metrics.

A numpy copy of egom2p_tpu/data/cam_gaze.py, so that the port never imports
the JAX package.  Host-side numpy utilities matching the reference datasets:
  * camera canonicalization to first-pose-relative 9D (column-major 6D
    rotation + translation) (reference: egom2p/data/cam_traj_dataset.py:156-164),
  * per-dim standardization with the published training-set statistics
    (reference: egom2p/utils/data_constants.py:47-49),
  * per-dataset coordinate-convention rotations (opengl / holoassist / cw90,
    reference: cam_traj_dataset.py:65-127),
  * gaze resolution conversion + NaN/outlier masking
    (reference: egom2p/data/gaze_dataset.py:169-193),
  * ATE / RTE / RRE trajectory metrics used by the cam round-trip golden test
    (reference: example_data/tok_cam_example.py:88-201),
  * seeded smooth camera paths and gaze tracks for the tokenizers' checks
    (the port's own).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Training-set statistics of the canonicalized 9D cam representation
# (reference: egom2p/utils/data_constants.py:47-49)
CAM_MEAN = np.array([
    0.9330503976511908, 0.004411310479848365, -0.004745505205447648,
    -0.004031105018382311, 0.9670221745404669, 0.01229744056849661,
    0.0025366981809852238, -0.002534521133857395, 0.03687088469884694,
])
CAM_STD = np.array([
    0.22410282941424692, 0.15409594854789294, 0.23538762722445528,
    0.151592393482513, 0.09890854498671052, 0.17871060521456542,
    0.16229749698697332, 0.11305994570310635, 0.22450155613920986,
])

GAZE_MEAN = np.array([0.5, 0.5])  # [0,1] -> [-1,1] (gaze_dataset.py:20-21)
GAZE_STD = np.array([0.5, 0.5])

# Per-dataset camera-convention change-of-basis matrices
# (reference: cam_traj_dataset.py:65, 96, 122)
CW90 = np.array([[0, 1, 0, 0], [-1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float64)
OPENGL_TO_OPENCV = np.diag([1.0, -1.0, -1.0, 1.0])
HOLOCAM_TO_OPENCV = np.array(
    [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], dtype=np.float64)


def canonicalize_cam(sample: np.ndarray) -> np.ndarray:
    """(T, 4, 4) opencv poses -> first-pose-relative 9D: column-major first two
    rotation columns + translation (reference: cam_traj_dataset.py:156-164)."""
    inv = np.linalg.inv(sample[0])
    canoed = np.einsum("ij,kjl->kil", inv, sample)
    rot6d = canoed[:, :3, :2]
    transl = canoed[:, :3, 3:]
    return np.concatenate((rot6d, transl), axis=-1).transpose(0, 2, 1).reshape(-1, 9)


def normalize_cam(cam_9d: np.ndarray) -> np.ndarray:
    return (cam_9d - CAM_MEAN) / CAM_STD


def denormalize_cam(cam_9d_normed: np.ndarray) -> np.ndarray:
    return cam_9d_normed * CAM_STD + CAM_MEAN


def smooth_cam_trajectories(rng: np.random.Generator, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n smooth 60-pose camera paths drawn from `rng` (a yaw swing and a
    drift), canonicalised to first-pose-relative 9D and standardised as the
    cam dataset does: the tokenizer's input (n, 60, 9) fp32 and the 9D
    ground truth (n, 60, 9) fp64."""
    t = np.linspace(0.0, 2.0, 60)
    gts = []
    for _ in range(n):
        yaw = 0.3 * np.sin(t * rng.uniform(0.5, 2.0))
        poses = np.tile(np.eye(4), (60, 1, 1))
        poses[:, 0, 0] = poses[:, 2, 2] = np.cos(yaw)
        poses[:, 0, 2], poses[:, 2, 0] = np.sin(yaw), -np.sin(yaw)
        poses[:, :3, 3] = t[:, None] * rng.normal(size=3) * 0.5
        gts.append(canonicalize_cam(poses))
    gt = np.stack(gts)
    return normalize_cam(gt).astype(np.float32), gt


def smooth_gaze_tracks(rng: np.random.Generator, n: int, invalid: float = 0.2) -> np.ndarray:
    """n smooth 60-frame gaze tracks drawn from `rng`, as the gaze dataset
    gives them to the tokenizer (n, 60, 3) fp32: x, y in [-1, 1] (a slow
    sweep of random frequency and phase per axis plus a little jitter) and
    a validity channel with runs of invalid frames covering about `invalid`
    of each track (blinks, the gaze outside the frame), where x, y are 0."""
    t = np.linspace(0.0, 2.0, 60)
    freq = rng.uniform(0.3, 1.5, (n, 1, 2))
    phase = rng.uniform(0, 2 * np.pi, (n, 1, 2))
    xy = 0.6 * np.sin(2 * np.pi * freq * t[None, :, None] + phase)
    xy = np.clip(xy + rng.normal(0.0, 0.02, xy.shape), -1.0, 1.0)
    valid = np.ones((n, 60))
    for row in valid:
        gap = int(rng.integers(0, int(2 * invalid * 60) + 1))
        start = int(rng.integers(0, 60 - gap + 1))
        row[start:start + gap] = 0.0
    xy *= valid[..., None]
    return np.concatenate([xy, valid[..., None]], axis=-1).astype(np.float32)


def convert_gaze(gaze: np.ndarray, orig_res, resize_res, new_res=(480, 480)) -> np.ndarray:
    """Remap gaze coords through resize + center crop to [0,1] in the cropped
    frame, build the validity mask for NaN / far-out-of-frame points, and
    normalize to [-1,1].  Returns (T, 3): x, y, valid
    (reference: gaze_dataset.py:169-193)."""
    orig_res = np.asarray(orig_res, dtype=np.float64)
    resize_res = np.asarray(resize_res, dtype=np.float64)
    new_res = np.asarray(new_res, dtype=np.float64)
    g = gaze / orig_res
    g = g * resize_res
    g = g - (resize_res - new_res) / 2
    g = g / new_res

    mask = np.ones(g.shape[0])
    bad = np.isnan(g).any(-1)
    mask[bad] = 0
    g[bad] = 0.0
    out = (g > 1.2).any(-1)
    mask[out] = 0
    g[out] = 0.0
    out = (g < -0.2).any(-1)
    mask[out] = 0
    g[out] = 0.0

    g = (g - GAZE_MEAN) / GAZE_STD
    return np.concatenate([g, mask.reshape(-1, 1)], axis=-1)


def denormalize_gaze(g: np.ndarray) -> np.ndarray:
    return g * GAZE_STD + GAZE_MEAN


def cam_9d_to_mat(traj_9d: np.ndarray) -> np.ndarray:
    """9D -> (N,4,4) via Gram-Schmidt of the column-major 6D rotation
    (reference: tok_cam_example.py:47-87, vq_utils.py rot6d_to_rotmat)."""
    if traj_9d.ndim == 1:
        traj_9d = traj_9d.reshape(-1, 9)
    d6, transl = traj_9d[..., :6], traj_9d[..., 6:]
    a1, a2 = d6[..., :3], d6[..., 3:]
    n1 = np.linalg.norm(a1, axis=-1, keepdims=True)
    b1 = np.divide(a1, n1, out=np.zeros_like(a1), where=n1 != 0)
    dot = np.sum(b1 * a2, axis=-1, keepdims=True)
    b2 = a2 - dot * b1
    n2 = np.linalg.norm(b2, axis=-1, keepdims=True)
    b2 = np.divide(b2, n2, out=np.zeros_like(b2), where=n2 != 0)
    b3 = np.cross(b1, b2, axis=-1)
    rot = np.stack((b1, b2, b3), axis=-1)
    mats = np.zeros(traj_9d.shape[:-1] + (4, 4))
    mats[..., :3, :3] = rot
    mats[..., :3, 3] = transl
    mats[..., 3, 3] = 1.0
    return mats


def _rotmat_to_angle_rad(R: np.ndarray) -> np.ndarray:
    """Rotation angle of (N,3,3) matrices (no scipy dependency)."""
    tr = np.trace(R, axis1=-2, axis2=-1)
    cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return np.arccos(cos)


def calculate_ate(pred_4x4: np.ndarray, gt_4x4: np.ndarray) -> float:
    """Umeyama-aligned absolute trajectory RMSE
    (reference: tok_cam_example.py:89-127).

    NOTE parity quirk: like the reference, the Kabsch rotation is applied to
    the UNCENTERED prediction and no translation is solved
    (tok_cam_example.py:122-126), so a constant offset counts as error.
    The published golden numbers (ATE 0.00587 m) were produced with exactly
    this formula — do not "fix" it without breaking comparability."""
    pred_t = pred_4x4[:, :3, 3]
    gt_t = gt_4x4[:, :3, 3]
    pc = pred_t - pred_t.mean(axis=0)
    gc = gt_t - gt_t.mean(axis=0)
    W = gc.T @ pc
    U, _, Vt = np.linalg.svd(W)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        Vt[-1, :] *= -1
        R = U @ Vt
    aligned = (R @ pred_t.T).T
    err = gt_t - aligned
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))


def calculate_rpe(pred_4x4: np.ndarray, gt_4x4: np.ndarray, delta: int = 1) -> Tuple[float, float]:
    """Relative pose error: (RTE, RRE_deg)
    (reference: tok_cam_example.py:129-175)."""
    gt_rel = np.linalg.inv(gt_4x4[:-delta]) @ gt_4x4[delta:]
    pred_rel = np.linalg.inv(pred_4x4[:-delta]) @ pred_4x4[delta:]
    err = np.linalg.inv(gt_rel) @ pred_rel
    rte = float(np.sqrt(np.mean(np.sum(err[:, :3, 3] ** 2, axis=1))))
    ang = _rotmat_to_angle_rad(err[:, :3, :3])
    rre_deg = float(np.rad2deg(np.sqrt(np.mean(ang**2))))
    return rte, rre_deg


def evaluate_9d_trajectory(pred_9d: np.ndarray, gt_9d: np.ndarray, delta: int = 1) -> Dict[str, float]:
    pred = cam_9d_to_mat(pred_9d)
    gt = cam_9d_to_mat(gt_9d)
    ate = calculate_ate(pred, gt)
    rte, rre = calculate_rpe(pred, gt, delta)
    return {"ATE": ate, "RTE": rte, "RRE_deg": rre}
