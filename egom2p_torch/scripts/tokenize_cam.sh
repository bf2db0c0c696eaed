#!/bin/bash
# Batch cam-trajectory tokenization on the PyTorch port (tokenize_script/cam.sh
# without JAX): one process on the first CUDA device, one copy per dataset file
# (the cam / gaze tokenizers are small and host-bound).  Run from the repo root.
set -euo pipefail
CKPT=${CKPT:-ckpt/checkpoint-cam.pth}
DATA=${1:?usage: tokenize_cam.sh <dataset_dir_or_npy> [out_dir]}
OUT=${2:-tokens/cam/$(basename "$DATA")}
python -m egom2p_torch.cli.run_training_vqvae \
    --config cfgs/vqvae/cam.yaml \
    --resume "$CKPT" \
    --tokenize --tokenize_path "$DATA" \
    --tokenize_save_path "$OUT" --no_log_wandb
