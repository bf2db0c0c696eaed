"""EgoM2P rgb2gaze evaluation on the PyTorch port.

    python -m egom2p_torch.cli.eval_model_rgb2gaze --ckpt CKPT.pth \
        --gaze-tok-ckpt ckpt/checkpoint-gaze.pth --data DIR --out eval_out

5120 pre-tokenized tok_rgb tokens from each DIR/rgb2gaze_*.npz (`arr_0`) ->
30 tok_gaze tokens by ROAR (5 steps, temperature 0.01, CFG 2.0, top-p 0.8)
-> the gaze VQ-VAE decoder -> a (60, 2) gaze track in [0, 1] in
OUT/rgb2gaze/{file}_tok_gaze.npy (reference: eval_model_rgb2gaze.py).
--smoke runs on random weights; --device cpu runs on the CPU.
"""
from egom2p_torch.cli.eval_common import build_argparser, run_task


def main(argv=None):
    args = build_argparser("rgb2gaze").parse_args(argv)
    return run_task("rgb2gaze", args)


if __name__ == "__main__":
    main()
