#!/bin/bash
# Multi-node pretraining on the PyTorch port: the reference's slurm + torchrun
# form (train_slurm_script/clariden_main_500b_2048.slurm), the counterpart of
# train_scripts/launch_tpu_pod.sh.  Each node runs this one command; torchrun
# starts NPROC_PER_NODE processes (one a card) and the nodes meet at a c10d
# rendezvous on MASTER_ADDR:MASTER_PORT; the trainer reads torchrun's
# environment (egom2p_torch/core/distributed.py: NCCL between the cards).
#
# Usage, from the repo root on every node (node 0's address as MASTER_ADDR):
#   NNODES=2 NODE_RANK=0 MASTER_ADDR=node0 ./egom2p_torch/scripts/launch_torchrun.sh \
#       cfgs/egom2p/main_mod4.yaml
# Under slurm, NODE_RANK defaults to SLURM_NODEID:
#   srun --nodes 2 --ntasks-per-node 1 env MASTER_ADDR=node0 NNODES=2 \
#       ./egom2p_torch/scripts/launch_torchrun.sh cfgs/egom2p/main_mod4.yaml
set -euo pipefail
CONFIG=${1:-cfgs/egom2p/main_mod4.yaml}
NNODES=${NNODES:-1}
NODE_RANK=${NODE_RANK:-${SLURM_NODEID:-0}}
NPROC_PER_NODE=${NPROC_PER_NODE:-8}
MASTER_ADDR=${MASTER_ADDR:-localhost}
MASTER_PORT=${MASTER_PORT:-29500}
# checkpoints of several nodes need a SHARED dir; default to the config's
# output_dir, override with OUTPUT_DIR=/shared/run
OUT_FLAG=${OUTPUT_DIR:+--output_dir $OUTPUT_DIR}

# shellcheck disable=SC2086  # OUT_FLAG is two words or none
torchrun --nnodes "$NNODES" --node_rank "$NODE_RANK" --nproc_per_node "$NPROC_PER_NODE" \
    --rdzv_backend c10d --rdzv_endpoint "$MASTER_ADDR:$MASTER_PORT" \
    --rdzv_id egom2p \
    -m egom2p_torch.cli.run_training --config "$CONFIG" $OUT_FLAG
