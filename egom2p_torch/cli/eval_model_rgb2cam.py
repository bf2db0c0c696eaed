"""EgoM2P rgb2cam evaluation on the PyTorch port.

    python -m egom2p_torch.cli.eval_model_rgb2cam --ckpt CKPT.pth \
        --cam-tok-ckpt ckpt/checkpoint-cam.pth --data DIR --out eval_out

5120 pre-tokenized tok_rgb tokens from each DIR/rgb2cam_*.npz (`arr_0`) ->
30 tok_cam tokens by ROAR (3 steps, temperature 0.01, CFG 2.0, top-p 0.8) ->
the cam VQ-VAE decoder -> a de-standardised (60, 9) trajectory (column-major
6-D rotation + translation per frame) in OUT/rgb2cam/{file}_tok_cam.npy
(reference: eval_model_rgb2cam.py).  --smoke runs on random weights;
--device cpu runs on the CPU.
"""
from egom2p_torch.cli.eval_common import build_argparser, run_task


def main(argv=None):
    args = build_argparser("rgb2cam").parse_args(argv)
    return run_task("rgb2cam", args)


if __name__ == "__main__":
    main()
