"""3-D camera-trajectory plot: the port's counterpart of vis_3d/vis_cam.py.

Plots a reconstructed and a ground-truth 9D trajectory as 3-D paths, with
the camera's z axis drawn every 10 frames at half alpha, and writes
`<output>/trajectory.png` (1200 x 1200 px).  The points and ticks are the
arrays the root tool hands matplotlib; vis_3d/render.py draws them with
numpy, without axis text or a legend: ground truth in tab:blue (#1f77b4),
the reconstruction in tab:red (#d62728).

    python -m egom2p_torch.vis_3d.vis_cam --recon pred_tok_cam.npy \
        [--gt gt_cam.npy] --output cam_vis
"""
from __future__ import annotations

import argparse
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from egom2p_torch.data.cam_gaze import cam_9d_to_mat, canonicalize_cam
from egom2p_torch.vis_3d import render

TRACKS = (("ground truth", "#1f77b4"), ("reconstruction", "#d62728"))
TICK_EVERY = 10
TICK_LENGTH = 0.02
LINE_RADIUS = 2              # lw 2 pt at 150 dpi: about 4 px
TICK_RADIUS = 1


class Track(NamedTuple):
    label: str
    color: str
    positions: np.ndarray                        # (T, 3)
    ticks: List[Tuple[np.ndarray, np.ndarray]]   # (tail (3,), camera z * TICK_LENGTH (3,))


def trajectory_tracks(recon_9d: np.ndarray, gt_9d: Optional[np.ndarray]) -> List[Track]:
    """The ground truth's track (if any), then the reconstruction's: the
    camera positions and, every TICK_EVERY frames, the camera's z axis
    scaled by TICK_LENGTH (vis_3d/vis_cam.py:34-40)."""
    tracks = []
    for traj_9d, (label, color) in zip((gt_9d, recon_9d), TRACKS):
        if traj_9d is None:
            continue
        mats = cam_9d_to_mat(traj_9d)
        t = mats[:, :3, 3]
        ticks = [(t[i], mats[i, :3, 2] * TICK_LENGTH) for i in range(0, len(mats), TICK_EVERY)]
        tracks.append(Track(label, color, t, ticks))
    return tracks


def plot_trajectories(recon_9d: np.ndarray, gt_9d: Optional[np.ndarray], out_png: str):
    """Write the PNG of the two tracks; returns them and the box's limits."""
    tracks = trajectory_tracks(recon_9d, gt_9d)
    lines = []
    for tr in tracks:
        lines.append(render.Polyline(tr.positions, tr.color, 1.0, LINE_RADIUS))
        lines += [render.Polyline(np.stack([tail, tail + z]), tr.color, 0.5, TICK_RADIUS)
                  for tail, z in tr.ticks]
    limits = render.render_png(out_png, lines)
    print(f"wrote {out_png}")
    return tracks, limits


def load_traj(path: str) -> np.ndarray:
    """(T, 9) canonicalized or (T, 4, 4) pose npy (both flags accept both,
    like cam_viz_tool.py's load())."""
    arr = np.load(path)
    if arr.ndim == 3 and arr.shape[-2:] == (4, 4):
        arr = canonicalize_cam(arr)
    return arr


def main(argv=None) -> str:
    """Parse `argv`, write the PNG, and return its path."""
    p = argparse.ArgumentParser("camera trajectory plot (PyTorch port)")
    p.add_argument("--recon", required=True, help="(T, 9) npy")
    p.add_argument("--gt", default=None, help="(T, 9) or (T, 4, 4) npy")
    p.add_argument("--output", default="cam_vis")
    args = p.parse_args(argv)
    os.makedirs(args.output, exist_ok=True)
    out = os.path.join(args.output, "trajectory.png")
    plot_trajectories(load_traj(args.recon), load_traj(args.gt) if args.gt else None, out)
    return out


if __name__ == "__main__":
    main()
