"""EgoM2P depth2rgb evaluation on the PyTorch port.

    python -m egom2p_torch.cli.eval_model_depth2rgb --ckpt CKPT.pth \
        --video-tok-ckpt ckpt/cosmos-dv4x8x8/encoder.jit --data DIR --out eval_out

tok_depth conditioning from each DIR/dep2rgb_*.mp4 -> tok_rgb by ROAR
(3 steps, temperature 0.01, CFG 2.0, top-p 0.8) -> a 16-frame mp4 under
OUT/depth2rgb (reference: eval_model_depth2rgb.py).  --smoke runs on random
weights; --device cpu runs on the CPU.
"""
from egom2p_torch.cli.eval_common import build_argparser, run_task


def main(argv=None):
    args = build_argparser("depth2rgb").parse_args(argv)
    return run_task("depth2rgb", args)


if __name__ == "__main__":
    main()
