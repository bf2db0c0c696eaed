"""Offline video pre-tokenization: the PyTorch port's entry point.

Port of tokenize_videos.py (reference: cosmos_tokenizer/video_cli.py:
158-299), with its flags: it walks tar shards (brace patterns, through
data/tar_reader.py:braceexpand) or a directory of mp4 clips, decodes each
clip on a thread with the native ingest library (data/video_ingest.py:
read_video: fps resample, center square crop, Lanczos scale to --size),
edge-pads a short clip to --max-frames and skips a clip that fails to
decode with a print, tokenizes --batch clips at a time with the Cosmos
DV4x8x8 tokenizer in --temporal-window frame windows, and writes each
clip's tokens as a `{key}.npz` member (int32, np.savez_compressed) of an
output tar named like its input shard (shard-000000.tar for a directory).

The tokenizer computes as the JAX package's default (bf16 input and Haar
patch, fp32 network, the card's products in exact fp32).  Its weights are
--video-tok-ckpt: an encoder.jit (the decoder.jit beside it is picked up)
or a .pth of the whole network (core/checkpoint.py:load_cosmos_dv_pth); a
missing checkpoint raises unless --smoke asks for random weights (the JAX
script falls back to random weights with a warning).

    python -m egom2p_torch.cli.tokenize_videos --input 'shards/shard-{000000..000195}.tar' \
        --output-dir tokens/rgb --video-tok-ckpt ckpt/cosmos-dv4x8x8/encoder.jit
    python -m egom2p_torch.cli.tokenize_videos --input clips_dir/ --output-dir tokens/rgb --smoke

It runs on the first CUDA device (--device cuda, the default) and raises
when there is none; --device cpu asks for the CPU.
"""
from __future__ import annotations

import argparse
import glob
import io
import os
import queue
import tarfile
import tempfile
import threading
import time
from typing import Callable, Dict

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser("video pre-tokenization (PyTorch)")
    p.add_argument("--input", required=True,
                   help="tar shard pattern (brace expansion) or a directory of mp4s")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--video-tok-ckpt", default="./ckpt/cosmos-dv4x8x8/encoder.jit",
                   help="Cosmos DV tokenizer: encoder.jit (its sibling decoder.jit is "
                        "picked up) or a .pth of the whole network")
    p.add_argument("--fps", type=float, default=8.0)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--temporal-window", type=int, default=17)
    p.add_argument("--batch", type=int, default=8, help="clips tokenized per device batch")
    p.add_argument("--max-frames", type=int, default=16,
                   help="frames per clip after resampling (2s @ 8fps)")
    p.add_argument("--smoke", action="store_true",
                   help="random tokenizer weights (pipeline check)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run; cuda raises when no CUDA device is found")
    return p.parse_args(argv)


def iter_clips(args):
    """Yield (key, mp4 bytes or path, output tar name)."""
    from egom2p_torch.data.tar_reader import braceexpand

    if os.path.isdir(args.input):
        for f in sorted(glob.glob(os.path.join(args.input, "*.mp4"))):
            yield os.path.splitext(os.path.basename(f))[0], f, "shard-000000.tar"
        return
    for shard in braceexpand(args.input):
        out_name = os.path.basename(shard)
        with tarfile.open(shard, "r") as tar:
            for member in tar:
                if not member.isfile() or not member.name.endswith(".mp4"):
                    continue
                f = tar.extractfile(member)
                if f is None:
                    continue
                key = os.path.splitext(os.path.basename(member.name))[0]
                yield key, f.read(), out_name


def decode_clip(args, src) -> np.ndarray:
    """(--max-frames, --size, --size, 3) uint8 frames of an mp4 (bytes or a
    path); a short clip is edge-padded with its last frame (the reference
    pads in time, utils.py:366-376)."""
    from egom2p_torch.data.video_ingest import read_video

    kw = dict(out_size=args.size, target_fps=args.fps, max_frames=args.max_frames)
    if isinstance(src, bytes):
        with tempfile.NamedTemporaryFile(suffix=".mp4") as tmp:
            tmp.write(src)
            tmp.flush()
            video = read_video(tmp.name, **kw)
    else:
        video = read_video(src, **kw)
    if video.shape[0] < args.max_frames:
        pad = args.max_frames - video.shape[0]
        video = np.concatenate([video, np.repeat(video[-1:], pad, axis=0)], axis=0)
    return video[:args.max_frames]


def decode_worker(args, clip_iter, q) -> None:
    """Decode clips into `q`, skipping (with a print) a clip that fails;
    None marks the end, also when the input stream itself fails."""
    try:
        for key, src, out_name in clip_iter:
            try:
                q.put((key, decode_clip(args, src), out_name))
            except Exception as e:  # a bad clip: skip it, as wds warn_and_continue
                print(f"[skip] {key}: {e}")
    except Exception as e:
        print(f"[tokenize_videos] input stream failed: {e}")
    finally:
        q.put(None)


def write_batch(tok, batch, get_tar: Callable[[str], tarfile.TarFile],
                temporal_window: int = 17) -> int:
    """Tokenize one batch of (key, (T, H, W, 3) uint8 clip, output tar
    name) and add each clip's tokens to its tar as `{key}.npz` (int32:
    the DV codebook has 64k entries; np.savez_compressed).  Returns the
    number of clips."""
    videos = np.stack([clip for _, clip, _ in batch])
    tokens = tok.forward(videos, temporal_window=temporal_window)
    for (key, _, out_name), toks in zip(batch, tokens):
        buf = io.BytesIO()
        np.savez_compressed(buf, toks.astype(np.int32))
        data = buf.getvalue()
        info = tarfile.TarInfo(name=f"{key}.npz")
        info.size = len(data)
        get_tar(out_name).addfile(info, io.BytesIO(data))
    return len(batch)


def load_tokenizer(args, device):
    """The Cosmos tokenizer (eval_common.COSMOS_CONFIG) on `device`; --smoke
    weights from seed 0, as the JAX script's PRNGKey(0)."""
    from egom2p_torch.cli.eval_common import load_video_tokenizer
    return load_video_tokenizer(argparse.Namespace(**vars(args), seed=0), device)


def main(argv=None) -> Dict[str, int]:
    """Tokenize every clip of --input; returns {output tar: clips}."""
    from egom2p_torch.cli.eval_common import resolve_device

    args = get_args(argv)
    tok = load_tokenizer(args, resolve_device(args.device))
    os.makedirs(args.output_dir, exist_ok=True)
    q: "queue.Queue" = queue.Queue(maxsize=args.batch * 4)
    t = threading.Thread(target=decode_worker, args=(args, iter_clips(args), q), daemon=True)
    t.start()
    out_tars: Dict[str, tarfile.TarFile] = {}
    counts: Dict[str, int] = {}

    def get_tar(name):
        if name not in out_tars:
            out_tars[name] = tarfile.open(os.path.join(args.output_dir, name), "w")
        counts[name] = counts.get(name, 0) + 1
        return out_tars[name]

    n_done, batch = 0, []
    t0 = time.time()
    try:
        while True:
            item = q.get()
            if item is not None:
                batch.append(item)
            if batch and (item is None or len(batch) == args.batch):
                n_done += write_batch(tok, batch, get_tar, args.temporal_window)
                batch = []
                print(f"tokenized {n_done} clips ({n_done / (time.time() - t0):.2f} clips/s)",
                      flush=True)
            if item is None:
                break
    finally:
        for tar in out_tars.values():
            tar.close()
    t.join()  # it has put the end mark
    print(f"done: {n_done} clips in {time.time() - t0:.1f}s -> {sorted(out_tars)}")
    return counts


if __name__ == "__main__":
    main()
