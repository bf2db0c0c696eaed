"""EgoM2P rgb2depth evaluation on the PyTorch port.

    python -m egom2p_torch.cli.eval_model_rgb2depth --ckpt CKPT.pth \
        --video-tok-ckpt ckpt/cosmos-dv4x8x8/encoder.jit --data DIR --out eval_out

tok_rgb conditioning from each DIR/rgb2dep_*.mp4 -> tok_depth by ROAR
(3 steps, temperature 0.01, CFG 2.0, top-p 0.8) -> a gray 16-frame mp4 under
OUT/rgb2depth (reference: eval_model_rgb2depth.py).  --smoke runs on random
weights; --device cpu runs on the CPU.
"""
from egom2p_torch.cli.eval_common import build_argparser, run_task


def main(argv=None):
    args = build_argparser("rgb2depth").parse_args(argv)
    return run_task("rgb2depth", args)


if __name__ == "__main__":
    main()
