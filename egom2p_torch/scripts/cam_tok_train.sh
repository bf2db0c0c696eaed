#!/bin/bash
# Cam tokenizer training on the PyTorch port (train_scripts/cam_tok_train.sh
# without JAX; reference: train_slurm_script/cam_tok_train.slurm).  Run from
# the repo root; extra flags go to the CLI (e.g. --device cpu).
set -euo pipefail
python -m egom2p_torch.cli.run_training_vqvae --config cfgs/vqvae/cam.yaml \
    --data_path "${1:?usage: cam_tok_train.sh <clips.npy> [extra flags]}" "${@:2}"
