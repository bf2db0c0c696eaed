"""Gaze tokenizer round trip: the port's counterpart of
example_data/tok_gaze_example.py.

Tokenizes `--gaze` (60 x 2 gaze points in [0, 1]) to 30 tokens,
reconstructs them, and prints the MSE of the reconstruction against the
converted input over its valid frames.  Both legs are the port's VQ-VAE
CLI with --tokenize, run in this process (examples/tok_cam_example.py:
round_trip); it writes <out>/token/<stem>-tok.npz and <stem>-recon.npy.

    python -m egom2p_torch.examples.tok_gaze_example --ckpt ckpt/checkpoint-gaze.pth \
        [--gaze example_data/gaze.npy] [--out example_data] [--device cpu]

`--random-init` runs on the CLI's seeded random weights.  Everything runs
on the first CUDA device (--device cuda, the default) and raises when there
is none.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from egom2p_torch.examples.tok_cam_example import get_args, round_trip


def main(argv=None, cli_args: Sequence[str] = ()) -> Dict[str, float]:
    """Parse `argv`, run the round trip, print and return {"MSE": ...}."""
    from egom2p_torch.data.cam_gaze import convert_gaze

    args = get_args(argv, "gaze")
    _, recon_path = round_trip("gaze", args.data, args.ckpt, args.out, args.random_init,
                               args.device, cli_args)
    conv = convert_gaze(np.load(args.data), orig_res=[896, 504], resize_res=[896, 504],
                        new_res=[480, 480])
    gt = conv[:, :2] * 0.5 + 0.5  # back to [0, 1]
    valid = conv[:, 2] > 0
    pred = np.load(recon_path)
    mse = ((gt[valid] - pred[valid]) ** 2).mean()
    print()
    print("#######################################")
    print("MSE for gaze_recon and gaze_input:")
    print("MSE:", mse)
    return {"MSE": float(mse)}


if __name__ == "__main__":
    main()
