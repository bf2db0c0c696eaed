"""Gaze-overlay visualization: the port's counterpart of vis_3d/vis_gaze.py.

Overlays predicted (and optionally ground-truth) gaze points on a video
clip read at 256 px and writes `<output>/<video>_gaze.mp4`.  The numpy
arithmetic is the root tool's, so the frames are bitwise its frames; the
mp4 legs go through data/video_ingest.py (libav, built at first use).

    python -m egom2p_torch.vis_3d.vis_gaze --video clip.mp4 \
        --gaze pred_tok_gaze.npy [--gt gt_gaze.npy] --output gaze_vis
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _draw_point(frame, xy, color, radius=4):
    h, w, _ = frame.shape
    x = int(np.clip(xy[0], 0, 1) * (w - 1))
    y = int(np.clip(xy[1], 0, 1) * (h - 1))
    y0, y1 = max(0, y - radius), min(h, y + radius + 1)
    x0, x1 = max(0, x - radius), min(w, x + radius + 1)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (yy - y) ** 2 + (xx - x) ** 2 <= radius ** 2
    frame[y0:y1, x0:x1][mask] = color
    return frame


def overlay_gaze(video, gaze, color=(255, 32, 32)):
    """video (T, H, W, 3) uint8 @ video fps; gaze (Tg, 2) in [0,1] @ 30 fps.
    Gaze is resampled to the video length; a frame whose gaze holds a NaN
    is left as it is."""
    out = video.copy()
    T = len(video)
    idx = np.linspace(0, len(gaze) - 1, T).round().astype(int)
    for t in range(T):
        g = gaze[idx[t]]
        if np.isnan(g).any():
            continue
        out[t] = _draw_point(out[t], g, color)
    return out


def main(argv=None) -> str:
    """Parse `argv`, write the overlaid clip, and return its path."""
    from egom2p_torch.data.video_ingest import read_video, write_video

    p = argparse.ArgumentParser("gaze overlay (PyTorch port)")
    p.add_argument("--video", required=True)
    p.add_argument("--gaze", required=True, help="(T, 2) npy in [0,1]")
    p.add_argument("--gt", default=None, help="optional (T, 2) npy in [0,1]")
    p.add_argument("--output", default="gaze_vis")
    p.add_argument("--fps", type=float, default=8.0)
    args = p.parse_args(argv)
    os.makedirs(args.output, exist_ok=True)

    video = read_video(args.video, out_size=256)
    out = overlay_gaze(video, np.load(args.gaze), color=(255, 32, 32))
    if args.gt:
        out = overlay_gaze(out, np.load(args.gt), color=(32, 255, 32))
    path = os.path.join(args.output, os.path.basename(args.video) + "_gaze.mp4")
    write_video(path, out, fps=args.fps)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
