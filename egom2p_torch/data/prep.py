"""Offline training-data preparation for the cam/gaze tokenizers.

Port of egom2p_tpu/data/prep.py on the port's numpy copy data/cam_gaze.py:
the same numbers, bitwise.

Generic equivalents of the reference's dataset builders
(reference: egom2p/data/load_cam.py, egom2p/data/load_gaze.py,
cam_traj_dataset.py): read raw pose/gaze streams, apply per-dataset camera
coordinate conventions, cut into 60-frame (2 s @ 30 fps) windows with temporal
overlap augmentation, canonicalize + standardize, and write the stacked npy
training sets consumed by run_training_vqvae.py.
"""
from __future__ import annotations

import os
import re
from typing import List, Sequence

import numpy as np

from egom2p_torch.data.cam_gaze import (CW90, HOLOCAM_TO_OPENCV, OPENGL_TO_OPENCV,
                                        canonicalize_cam, convert_gaze)

CONVENTIONS = {
    "opencv": np.eye(4),
    "opengl": OPENGL_TO_OPENCV,
    "holoassist": HOLOCAM_TO_OPENCV,
    "cw90": CW90,
}


def natural_sort_key(s, _nsre=re.compile(r"([0-9]+)")):
    """(reference: load_cam.py:8-9)"""
    return [int(t) if t.isdigit() else t.lower() for t in _nsre.split(s)]


def temporal_overlap_augmentation(data: np.ndarray, stride: int = 10,
                                  sequence_length: int = 60) -> List[np.ndarray]:
    """Sliding windows with overlap (reference: load_cam.py:17-21)."""
    return [data[s:s + sequence_length]
            for s in range(0, len(data) - sequence_length + 1, stride)]


def read_pose_txt(path: str) -> np.ndarray:
    """Tab-separated pose export (id, ts, 16 matrix entries) -> (T, 4, 4)
    (reference: load_cam.py:34-44)."""
    rows = []
    with open(path) as f:
        for line in f.read().split("\n"):
            if not line:
                break  # reference-exact: first empty line ends the file
                       # (load_cam.py:40-41 treats it as "end of the lines")
            rows.append(list(map(float, line.strip().split("\t"))))
    return np.asarray(rows)[:, 2:].reshape(-1, 4, 4)


def build_cam_training_set(pose_files: Sequence[str], out_path: str,
                           convention: str = "opencv", stride: int = 10,
                           clip_len: int = 60) -> np.ndarray:
    """Poses -> stacked canonicalized 9D windows (N, clip_len, 9).

    Note: standardization uses the published CAM_MEAN/STD at train time
    (applied by run_training_vqvae.py), so the npy stores raw canonicalized 9D.
    """
    conv = CONVENTIONS[convention]
    windows = []
    for f in sorted(pose_files, key=natural_sort_key):
        poses = (np.load(f) if f.endswith((".npy", ".npz")) else read_pose_txt(f))
        if hasattr(poses, "files"):
            poses = poses[poses.files[0]]
        poses = poses @ conv
        for w in temporal_overlap_augmentation(poses, stride, clip_len):
            if np.isnan(w).any():
                continue
            windows.append(canonicalize_cam(w))
    out = np.stack(windows) if windows else np.zeros((0, clip_len, 9))
    np.save(out_path, out)
    print(f"wrote {out.shape} -> {out_path}")
    return out


def build_gaze_training_set(gaze_files: Sequence[str], out_path: str,
                            orig_res, resize_res=None, new_res=(480, 480),
                            stride: int = 10, clip_len: int = 60) -> np.ndarray:
    """2D gaze streams -> stacked converted windows (N, clip_len, 3)
    with x/y normalized to [-1, 1] plus validity mask
    (reference: load_gaze.py + gaze_dataset.convert)."""
    resize_res = resize_res or orig_res
    windows = []
    for f in sorted(gaze_files, key=natural_sort_key):
        gaze = np.load(f)
        if hasattr(gaze, "files"):
            gaze = gaze[gaze.files[0]]
        conv = convert_gaze(gaze, orig_res=orig_res, resize_res=resize_res,
                            new_res=new_res)
        windows.extend(temporal_overlap_augmentation(conv, stride, clip_len))
    out = np.stack(windows) if windows else np.zeros((0, clip_len, 3))
    np.save(out_path, out)
    print(f"wrote {out.shape} -> {out_path}")
    return out


def compute_cam_stats(cam_9d_windows: np.ndarray):
    """Per-dim mean/std of the canonicalized 9D training set
    (how CAM_MEAN/CAM_STD were produced, reference: data_constants.py:46)."""
    flat = cam_9d_windows.reshape(-1, 9)
    return flat.mean(0), flat.std(0)


# ------------------------------------------------- HoloAssist eye projection
# camera-axis convention used by the HoloAssist exports
# (reference: holoassist_eye_proj.py:9-10)
AXIS_TRANSFORM = np.linalg.inv(
    np.array([[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]],
             dtype=np.float64))


def read_gaze_txt(path: str) -> np.ndarray:
    """Tab-separated eye export (id, ts, origin xyz, direction xyz, ...)
    (reference: holoassist_eye_proj.py:38-48)."""
    rows = []
    with open(path) as f:
        for line in f.read().split("\n"):
            if not line:
                break
            rows.append(list(map(float, line.strip().split("\t"))))
    return np.asarray(rows)


def read_intrinsics_txt(path: str):
    """(reference: holoassist_eye_proj.py:30-36)."""
    with open(path) as f:
        data = list(map(float, f.read().split("\t")))
    return np.asarray(data[:9]).reshape(3, 3), data[-2], data[-1]


def get_eye_gaze_point(gaze_row: np.ndarray, dist: float = 0.5) -> np.ndarray:
    """World-space gaze point = origin + dist * normalized direction
    (reference: holoassist_eye_proj.py:50-56; 50 cm default)."""
    origin = gaze_row[2:5]
    direction = gaze_row[5:8]
    direction = direction / np.linalg.norm(direction)
    return origin + direction * dist


def project_eye_gaze(gaze_rows: np.ndarray, cam_poses: np.ndarray,
                     intrinsics: np.ndarray, eye_dist: float = 0.5
                     ) -> np.ndarray:
    """Project per-frame world gaze points into the image
    (reference: holoassist_eye_proj.py:99-114): transform by the inverse
    camera pose and the HoloLens axis convention, then pinhole-project (the
    reference's cv2.projectPoints with zero rvec/tvec/distortion).

    gaze_rows: (T, >=8) eye export rows; cam_poses: (T, 4, 4) world-from-
    camera poses; intrinsics: (3, 3).  Returns (T, 2) pixel coordinates."""
    n = min(len(gaze_rows), len(cam_poses))
    out = np.zeros((n, 2), dtype=np.float64)
    for t in range(n):
        point = get_eye_gaze_point(gaze_rows[t], eye_dist)
        p = AXIS_TRANSFORM @ (np.linalg.inv(cam_poses[t])
                              @ np.concatenate([point, [1.0]]))
        uvw = intrinsics @ (p[:3] / p[2])
        out[t] = uvw[:2] / uvw[2]
    return out


def is_neighbor(file1: str, file2: str) -> bool:
    """Consecutively-numbered clip files (reference: load_cam.py:11-15)."""
    parts1, parts2 = file1.split("_"), file2.split("_")
    return (parts1[:-1] == parts2[:-1]
            and int(parts1[-1].split(".")[0])
            - int(parts2[-1].split(".")[0]) == -1)


def concat_neighbor_windows(files: Sequence[str], load_fn,
                            stride: int = 10, clip_len: int = 60
                            ) -> List[np.ndarray]:
    """Concatenate consecutive clip files and cut overlapping windows across
    their boundary (reference: load_cam.py:89-108): doubles the effective
    windows near clip seams without fabricating discontinuous data."""
    files = sorted(files, key=natural_sort_key)
    windows: List[np.ndarray] = []
    for a, b in zip(files, files[1:]):
        if not is_neighbor(os.path.basename(a), os.path.basename(b)):
            continue
        ta, tb = load_fn(a), load_fn(b)
        if np.isnan(ta).any() or np.isnan(tb).any():
            continue
        combined = np.concatenate([ta, tb], axis=0)
        windows.extend(temporal_overlap_augmentation(combined, stride,
                                                     clip_len))
    return windows
