#!/bin/bash
# Batch eye-gaze tokenization on the PyTorch port (tokenize_script/gaze.sh
# without JAX).  Run from the repo root.
set -euo pipefail
CKPT=${CKPT:-ckpt/checkpoint-gaze.pth}
DATA=${1:?usage: tokenize_gaze.sh <dataset_dir_or_npy> [out_dir]}
OUT=${2:-tokens/gaze/$(basename "$DATA")}
python -m egom2p_torch.cli.run_training_vqvae \
    --config cfgs/vqvae/gaze.yaml \
    --resume "$CKPT" \
    --tokenize --tokenize_path "$DATA" \
    --tokenize_save_path "$OUT" --no_log_wandb
