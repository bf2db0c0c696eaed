#!/bin/bash
# Gaze tokenizer training on the PyTorch port (train_scripts/gaze_train.sh
# without JAX; reference: train_slurm_script/gaze_train.slurm).  Run from the
# repo root; extra flags go to the CLI.
set -euo pipefail
python -m egom2p_torch.cli.run_training_vqvae --config cfgs/vqvae/gaze.yaml \
    --data_path "${1:?usage: gaze_train.sh <clips.npy> [extra flags]}" "${@:2}"
