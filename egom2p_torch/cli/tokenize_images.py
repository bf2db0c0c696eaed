"""Run the Cosmos image tokenizer (CI / DI) over plain images: the PyTorch
port's counterpart of the root tokenize_images.py, with its flags and
output files.

    python -m egom2p_torch.cli.tokenize_images --image_pattern 'imgs/*.jpg' \
        --checkpoint_enc ckpt/encoder.jit --checkpoint_dec ckpt/decoder.jit \
        --tokenizer_type DI --spatial_compression 16 --output_dir ./recon

Globs the images, optionally resamples the short side (--short_size,
Lanczos), autoencodes each through the CI or DI tokenizer
(tokenizers/cosmos/image_api.py: padded to the spatial compression,
unpadded after) and writes the reconstruction under the input's name in
--output_dir (else <image dir>/reconstructions); --save_input also writes
the (resized) input as <name>_input.<ext>, and --save_codes, for DI, the
token grid as <name>_codes.npy (int32, one encoder pass feeding both the
codes and the reconstruction).  Weights: --checkpoint (a whole-network
.pth or .jit) or --checkpoint_enc + --checkpoint_dec (the released
encoder.jit / decoder.jit; core/checkpoint.py:load_cosmos_image_pth), or
--random_init (weights from torch.Generator seed 0, for smoke tests).

Everything runs on the first CUDA device (--device cuda, the default) and
raises when there is none; --device cpu asks for the CPU.  Pillow reads and
writes the images (imported only there).
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run the Cosmos image tokenizer over plain images.")
    p.add_argument("--image_pattern", type=str, required=True, help="Glob pattern of input images.")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Full autoencoder .pth/.jit (torch state dict).")
    p.add_argument("--checkpoint_enc", type=str, default=None)
    p.add_argument("--checkpoint_dec", type=str, default=None)
    p.add_argument("--tokenizer_type", type=str, choices=["CI", "DI"], default="DI")
    p.add_argument("--spatial_compression", type=int, choices=[8, 16], default=16)
    p.add_argument("--short_size", type=int, default=None,
                   help="Resample the short side to this many pixels.")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--save_input", action="store_true",
                   help="Also write the (resized) input image.")
    p.add_argument("--save_codes", action="store_true",
                   help="DI only: write the token grid as <name>_codes.npy.")
    p.add_argument("--random_init", action="store_true",
                   help="Random weights (smoke testing without checkpoints).")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run; cuda raises when no CUDA device is found")
    return p.parse_args(argv)


def read_image(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


def write_image(path: str, image: np.ndarray) -> None:
    from PIL import Image
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(image).save(path)


def resize_image(image: np.ndarray, short_size=None) -> np.ndarray:
    """Short-side resample (reference: utils.py resize_image), Pillow's
    Lanczos computed without Pillow (data/resample.py)."""
    if short_size is None:
        return image
    from egom2p_torch.data.resample import resize
    h, w = image.shape[:2]
    if h < w:
        nh, nw = short_size, int(round(w * short_size / h))
    else:
        nh, nw = int(round(h * short_size / w)), short_size
    return resize(image, (nh, nw), "lanczos")


def build_tokenizer(args, device):
    """The CI or DI tokenizer at --spatial_compression on `device`."""
    from egom2p_torch.tokenizers.cosmos.image_api import ImageTokenizer
    from egom2p_torch.tokenizers.cosmos.image_network import (CI8x8_CONFIG, CI_CONFIG,
                                                              DI8x8_CONFIG, DI_CONFIG)

    discrete = args.tokenizer_type == "DI"
    if args.spatial_compression == 8:
        cfg = DI8x8_CONFIG if discrete else CI8x8_CONFIG
    else:
        cfg = DI_CONFIG if discrete else CI_CONFIG
    if args.random_init:
        return ImageTokenizer.random_init(torch.Generator(device).manual_seed(0), cfg,
                                          discrete=discrete)
    from egom2p_torch.core.checkpoint import load_cosmos_image_pth
    enc = args.checkpoint or args.checkpoint_enc
    dec = None if args.checkpoint else args.checkpoint_dec
    if enc is None:
        sys.exit("Need --checkpoint / --checkpoint_enc (+ --checkpoint_dec), "
                 "or --random_init for smoke tests.")
    return load_cosmos_image_pth(enc, dec, cfg=cfg, discrete=discrete, device=device)


def output_path(filepath: str, output_dir) -> str:
    base = os.path.basename(filepath)
    out_dir = output_dir or os.path.join(os.path.dirname(filepath), "reconstructions")
    return os.path.join(out_dir, base)


def encode_decode(tok, image: np.ndarray):
    """One uint8 (H, W, 3) image through DI: (int32 token grid, uint8
    reconstruction), from one encoder pass."""
    from egom2p_torch.tokenizers.cosmos.image_api import pad_image_batch, unpad_image_batch
    from egom2p_torch.tokenizers.cosmos.video_api import numpy2tensor, tensor2numpy

    padded, crop = pad_image_batch(image[None], tok.cfg.spatial_compression)
    indices, _ = tok.encode(torch.from_numpy(numpy2tensor(padded)))
    recon = unpad_image_batch(tensor2numpy(tok.decode(indices)), crop)[0]
    return indices[0].cpu().numpy().astype(np.int32), recon


def main(argv=None):
    from egom2p_torch.cli.eval_common import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    filepaths = sorted(glob.glob(args.image_pattern))
    if not filepaths:
        sys.exit(f"no images match {args.image_pattern!r}")
    tok = build_tokenizer(args, device)
    print(f"[tokenize_images] {len(filepaths)} images, "
          f"{args.tokenizer_type} f{args.spatial_compression} on {device}")
    save_codes = args.save_codes and args.tokenizer_type == "DI"
    for fp in filepaths:
        image = resize_image(read_image(fp), args.short_size)
        out_fp = output_path(fp, args.output_dir)
        os.makedirs(os.path.dirname(out_fp), exist_ok=True)
        if save_codes:
            codes, recon = encode_decode(tok, image)
            np.save(os.path.splitext(out_fp)[0] + "_codes.npy", codes)
        else:
            recon = tok.forward(image[None])[0]
        write_image(out_fp, recon)
        if args.save_input:
            stem, ext = os.path.splitext(out_fp)
            write_image(stem + "_input" + ext, image)
        print(f"  {fp} -> {out_fp}")


if __name__ == "__main__":
    main()
