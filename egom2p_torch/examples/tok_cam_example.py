"""Camera tokenizer round trip: the port's counterpart of
example_data/tok_cam_example.py.

Tokenizes `--cam` (60 x 4 x 4 opencv poses) to 30 tokens, reconstructs
them, and prints ATE / RTE / RRE of the reconstruction against the
canonicalized input.  Both legs are the port's VQ-VAE CLI
(cli/run_training_vqvae.py) with --tokenize, run in this process; it
writes <out>/token/<stem>-tok.npz and <stem>-recon.npy.  With the released
checkpoint-cam.pth and the reference's example_data/cam.npy the expected
output is about {'ATE': 0.00587, 'RTE': 0.00284, 'RRE_deg': 0.298}.

    python -m egom2p_torch.examples.tok_cam_example --ckpt ckpt/checkpoint-cam.pth \
        [--cam example_data/cam.npy] [--out example_data] [--device cpu]

`--random-init` runs the same path on the CLI's seeded random weights (no
checkpoint; the metrics are meaningless).  Everything runs on the first
CUDA device (--device cuda, the default) and raises when there is none.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Sequence

import numpy as np


def round_trip(domain: str, data: str, ckpt: str, out: str, random_init: bool, device: str,
               cli_args: Sequence[str] = ()):
    """Tokenize, then reconstruct `data` through the VQ-VAE CLI with the
    tokenizer of `ckpt` (or, with `random_init`, the CLI's seeded random
    weights; --resume is then left out and the CLI reads no checkpoint).
    `cli_args` go to the CLI after the others (tests pass small widths).
    Returns the paths of the tokens and of the reconstruction."""
    from egom2p_torch.cli import run_training_vqvae
    from egom2p_torch.core.device import resolve_device

    resolve_device(device)
    if not os.path.exists(data):
        raise FileNotFoundError(f"--{domain} {data} not found")
    if not random_init and not os.path.exists(ckpt):
        raise FileNotFoundError(f"--ckpt {ckpt} not found (pass --random-init for random "
                                f"weights)")
    resume = [] if random_init else ["--resume", ckpt]
    base = ["--domain", domain, *resume, "--tokenize", "--tokenize_path", data,
            "--tokenize_save_path", out, "--no_log_wandb", "--device", device, *cli_args]
    tokens = run_training_vqvae.main(base)
    return tokens, run_training_vqvae.main(base + ["--recon"])


def get_args(argv=None, domain: str = "cam"):
    p = argparse.ArgumentParser(f"{domain} tokenizer round trip (PyTorch port)")
    p.add_argument("--ckpt", default=f"ckpt/checkpoint-{domain}.pth")
    p.add_argument(f"--{domain}", dest="data", default=f"example_data/{domain}.npy")
    p.add_argument("--out", default="example_data")
    p.add_argument("--random-init", action="store_true",
                   help="smoke mode: run with random weights, no checkpoint")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run; cuda raises when no CUDA device is found")
    return p.parse_args(argv)


def main(argv=None, cli_args: Sequence[str] = ()) -> Dict[str, float]:
    """Parse `argv`, run the round trip, print and return the metrics."""
    from egom2p_torch.data.cam_gaze import canonicalize_cam, evaluate_9d_trajectory

    args = get_args(argv, "cam")
    _, recon_path = round_trip("cam", args.data, args.ckpt, args.out, args.random_init,
                               args.device, cli_args)
    cano_input = canonicalize_cam(np.load(args.data))
    recon = np.load(recon_path)
    metrics = evaluate_9d_trajectory(recon, cano_input, delta=1)
    print()
    print("###########################################")
    print("reconstructed vs input camera trajectory:")
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
