"""Generated tokens -> artifacts for the eval entry points.

Port of egom2p_tpu/generate/decode.py (reference:
egom2p/utils/plotting_utils.py:103-131, 159-180, 744-801): video token grids
become uint8 frames through the Cosmos decoder, then an 8 fps mp4; cam and
gaze tokens become de-standardised trajectories through their VQ-VAE
decoders, then a .npy of the first clip.  Each has two halves: the array
half (`decode_video_tokens`, `decode_cam_tokens`, `decode_gaze_tokens`:
tokens -> numpy, no file I/O) and the file half (`decode_tok_vid`,
`decode_tok_cam`, `decode_tok_gaze`).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from egom2p_torch.core import tracing
from egom2p_torch.data.cam_gaze import CAM_MEAN, CAM_STD, GAZE_MEAN, GAZE_STD
from egom2p_torch.tokenizers.cosmos.video_api import tensor2uint8

VIDEO_GRID = (5, 32, 32)
FRAMES = 16  # the decoded 17th frame is the temporal pad (reference: [0,0,0,16,256,256])


def decode_video_tokens(tokens, tokenizer, key: str = "tok_rgb",
                        grid=VIDEO_GRID) -> np.ndarray:
    """Token grids (B, t*h*w) or (B, t, h, w) -> uint8 video (B, 16, H, W, 3);
    depth becomes the channel mean, in gray (the floor of the mean, as
    numpy's uint8 cast of it)."""
    with tracing.span("egom2p.decode"):
        toks = torch.as_tensor(tokens)
        if toks.ndim != 4:
            toks = toks.reshape(toks.shape[0], *grid)
        video = tensor2uint8(tokenizer.decode(toks))[:, :FRAMES]
        if key == "tok_depth":
            gray = torch.div(video.sum(dim=-1, keepdim=True, dtype=torch.int32), 3,
                             rounding_mode="floor")
            video = gray.to(torch.uint8).expand(*video.shape)
        return video.cpu().numpy()


def decode_tok_vid(filename: str, mod_dict, tokenizers, key: str = "tok_rgb",
                   name: str = "tmp", grid=VIDEO_GRID) -> str:
    """Video tokens -> mp4 at 8 fps of the first clip of the batch
    (reference: plotting_utils.py:103-131)."""
    from egom2p_torch.data.video_ingest import write_video

    video = decode_video_tokens(mod_dict[key]["tensor"], tokenizers["tok_vid"], key, grid)
    os.makedirs(name, exist_ok=True)
    out = f"{name}/{filename}_{key}.mp4"
    write_video(out, video[0], fps=8)
    print("decode", key, "to", out)
    return out


def decode_cam_tokens(tokens, tokenizer) -> np.ndarray:
    """(B, 30) cam tokens -> de-standardised 9-D poses (B, 60, 9), float64
    numpy (reference: plotting_utils.py:159-169)."""
    rec = tokenizer.decode_tokens(tokens).cpu().numpy()
    return rec * CAM_STD + CAM_MEAN


def decode_gaze_tokens(tokens, tokenizer) -> np.ndarray:
    """(B, 30) gaze tokens -> gaze points in [0, 1] (B, 60, 2), float64
    numpy (reference: plotting_utils.py:171-180)."""
    rec = tokenizer.decode_tokens(tokens).cpu().numpy()
    return rec[..., :2] * GAZE_STD + GAZE_MEAN


def _save_first(filename: str, key: str, name: str, rec: np.ndarray) -> str:
    os.makedirs(name, exist_ok=True)
    out = f"{name}/{filename}_{key}.npy"
    np.save(out, rec[0])
    print("decode", key, "to", out)
    return out


def decode_tok_cam(filename: str, mod_dict, tokenizers, key: str = "tok_cam",
                   name: str = "tmp") -> str:
    """Cam tokens -> {name}/{filename}_{key}.npy of the first clip, (60, 9)."""
    return _save_first(filename, key, name,
                       decode_cam_tokens(mod_dict[key]["tensor"], tokenizers[key]))


def decode_tok_gaze(filename: str, mod_dict, tokenizers, key: str = "tok_gaze",
                    name: str = "tmp") -> str:
    """Gaze tokens -> {name}/{filename}_{key}.npy of the first clip, (60, 2)."""
    return _save_first(filename, key, name,
                       decode_gaze_tokens(mod_dict[key]["tensor"], tokenizers[key]))


_DECODERS = {
    "tok_rgb": decode_tok_vid,
    "tok_depth": decode_tok_vid,
    "tok_cam": decode_tok_cam,
    "tok_gaze": decode_tok_gaze,
}


def decode_targets(filename: str, mod_dict, tokenizers, target_mods,
                   name: str = "tmp") -> Dict[str, str]:
    """Decode only the generated target modalities
    (reference: plotting_utils.py:744-801)."""
    return {key: _DECODERS[key](filename, mod_dict, tokenizers, key=key, name=name)
            for key in target_mods}
