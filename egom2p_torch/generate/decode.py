"""Generated tokens -> artifacts for the eval entry points.

Port of egom2p_tpu/generate/decode.py (reference:
egom2p/utils/plotting_utils.py:103-131, 744-801): video token grids become
uint8 frames through the Cosmos decoder, then an 8 fps mp4.  The two halves
are separate functions: `decode_video_tokens` (tokens -> uint8 frames, on the
tokenizer's device) needs no video library, `decode_tok_vid` adds the mp4.

Not ported yet: the cam and gaze decoders (their VQ-VAE tokenizers and
data/cam_gaze.py; ROADMAP.md, Queue 1 item 4).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from egom2p_torch.tokenizers.cosmos.video_api import tensor2uint8

VIDEO_GRID = (5, 32, 32)
FRAMES = 16  # the decoded 17th frame is the temporal pad (reference: [0,0,0,16,256,256])


def decode_video_tokens(tokens, tokenizer, key: str = "tok_rgb",
                        grid=VIDEO_GRID) -> np.ndarray:
    """Token grids (B, t*h*w) or (B, t, h, w) -> uint8 video (B, 16, H, W, 3);
    depth becomes the channel mean, in gray (the floor of the mean, as
    numpy's uint8 cast of it)."""
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


def _not_ported(filename, mod_dict, tokenizers, key, name="tmp"):
    raise NotImplementedError(f"decoding {key} needs the cam/gaze tokenizers, which are not "
                              f"ported yet (ROADMAP.md, Queue 1 item 4)")


_DECODERS = {
    "tok_rgb": decode_tok_vid,
    "tok_depth": decode_tok_vid,
    "tok_cam": _not_ported,
    "tok_gaze": _not_ported,
}


def decode_targets(filename: str, mod_dict, tokenizers, target_mods,
                   name: str = "tmp") -> Dict[str, str]:
    """Decode only the generated target modalities
    (reference: plotting_utils.py:744-801)."""
    return {key: _DECODERS[key](filename, mod_dict, tokenizers, key=key, name=name)
            for key in target_mods}
