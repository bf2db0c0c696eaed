#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py

1. Builds the CUDA kernels of egom2p_torch/csrc with nvcc (sm_90a), one nvcc
   per source, all started together; prints ptxas's registers, spills and
   remarks per kernel instance and counts the wgmma (HGMMA) instructions in
   the SASS: every attention instance and the CE forward must hold them.
2. Serving kernel phase: the flash64 kernel against its plain PyTorch version
   at the rgb2depth main path's shapes (B=8, 12 heads of 64), in both softmax
   modes; prints the max abs error and the time of each, beside the time of
   torch's scaled_dot_product_attention on the same inputs and mask (a
   yardstick timed here only; the port never calls it).  Then the forward
   kernel at ragged lengths on both sides of its 128-row and 128-key tile
   edges, with key padding, segments and no mask, dead rows included.
3. Serving slice, at full width: Cosmos DV4x8x8 tokenize of a seeded uint8
   clip batch (8, 16, 256, 256, 3), then EgoM2P-base 3-step ROAR rgb2depth
   (CFG 2.0, temperature 0.01, top-p 0.8) with random --smoke weights,
   through the cli/eval_common loaders and GenerationSampler.generate.
   Checks token shapes and range, finite hidden states, the kernel's launch
   count (216 per generate: 12 encoder layers x 2 CFG branches + 12 decoder
   layers x 2 attentions x 2 branches, times 3 steps) and, on a B=1 input,
   the encoder context against the same model with plain attention; then
   greedy rgb2depth on the served batch with the generation head's product
   on TF32 and on full fp32: no token may differ.  The tokenizer computes as
   the JAX package's default (bf16 input and Haar patch, fp32 network): the
   batch is tokenized with the encoder's convs on TF32 and in exact fp32,
   with both times and the tokens that differ (TF32 is allowed only where
   none does).
3b. Eval phase, at full width: the served batch's depth tokens through the
   Cosmos decoder (fp32 (8, 17, 256, 256, 3), finite, then uint8 gray
   frames), its time on TF32 and in exact fp32 and the pixels that move
   (TF32 allowed only where none moves by more than a level), peak memory
   and the decoder's parameters; the smoke EgoM2P-base and Cosmos written
   to reference-format .pth files and loaded back through cli/eval_common
   without --smoke (greedy rgb2depth bitwise equal to the in-memory
   model's); then rgb2depth and depth2rgb on those files, one clip at a
   time (the entry points' per-clip work and the array half of the decode;
   the card's machine has no libav for the mp4 legs): per-clip tokenize,
   generate and decode seconds and 216 flash64 launches per generate.
3c. Cam / gaze eval phase, at full width: the cam and gaze VQ-VAEs (dim
   768, 12 + 12 blocks, 256 codes) with seeded random weights written to
   reference-format .pth files and loaded back through eval_common without
   --smoke; a tokenize -> decode round trip of seeded smooth camera paths
   at B = 8 and 1, in exact fp32 and on TF32 (ms per call, the tokens TF32
   changes and its largest change to the decoded values; ATE / RTE / RRE,
   finite); then main() of cli/eval_model_rgb2{cam,gaze}.py on those files
   and the eval phase's EgoM2P-base .pth, over npz files of the served
   clips' rgb tokens: per-file generate and decode seconds, (60, 9) /
   (60, 2) finite .npy files, and 72 / 120 flash64 launches per generate
   (12 encoder layers x 2 CFG branches x 3 or 5 steps; the decoder's 10 or
   6 rows a step take the dense path); greedy rgb2cam of one clip from the
   loaded files bitwise equal to the in-memory models; rgb2cam and rgb2gaze
   generate on the served tokens at B = 1 and 8 (median of 3, and a
   profiled rgb2cam run: device time by kernel class, idle share); and the flash64
   kernel at rgb2cam's B = 1 encoder shape (5376^2, 5140 live keys) beside
   its plain version, its bound and scaled_dot_product_attention.
3d. Caption phase, at full width: EgoM2P-base with tok_rgb, tok_depth,
   tok_cam, tok_gaze and caption (30000 ids, 256 slots) in and out, random
   weights from a seed, and a tokenizer.json the phase writes
   (CAPTION_WORDS, 100 sentinels).  rgb2caption at B = 8 on the served rgb
   tokens: an empty 256-slot caption (S = 255 output slots), CFG 2.0 on
   tok_rgb, temperature 0.01, top-p 0.8, through
   build_chained_generation_schedules(..., ["autoregressive"], ...) and
   GenerationSampler.generate: ms per generated token, tokens/s, 12 + 12 a
   token flash64 launches (the encoder once on the stacked 2B rows, then
   each token's re-forward's cross-attentions; the causal self-attention is
   dense), ids in [0, 30000), and a profiled stretch of re-forwards (device
   time by kernel class, idle share); the forward kernel at the
   autoregressive cross-attention's shape (16, 255, 5376: cond rows 5121
   live keys, uncond rows 1) against its plain version, beside its bound
   over the live keys and scaled_dot_product_attention; one re-forward's
   CFG logits in fp32 with the kernels against the plain versions.  Then
   caption2rgb at B = 8: ROAR in 3 steps over 5120 rgb tokens on a seeded
   caption with CFG 2.0 on the caption (the stacked 2B-row step): clips/s
   and 36 flash64 launches a step (12 encoder, 12 + 12 decoder).
3e. Multi-condition rgb2depth (GenerationSampler.generate_multi_guided)
   on the served EgoM2P-base and rgb tokens, B = 8: conditions {tok_rgb}
   and {tok_cam} (seeded cam tokens) at weights [2.0, 1.0], 3 ROAR steps,
   temperature 0.01, top-p 0.8: generate ms and clips/s (median of 3), 108
   flash64 launches a generate (one encoder over the stacked 3B rows, the
   decoder's self and cross attention, 12 each a step), every position
   filled; a greedy first step with the kernel against its plain version
   (the tokens that differ, at most MULTI_GREEDY_SHARE); then the encoder
   context of an EgoM2P-base over rgb@224 pixels (ImagePatchEncoderEmbedding,
   196 patches) and the rgb tokens, fp32, kernel against plain.
3f. generate_sam_dense at width 768, 2 + 2 blocks (caption + tok_rgb, a
   tokenizer.json the phase writes): SAM_BATCH sequences over one clip's
   rgb tokens, merged into one; ms and flash64 launches.
3g. The rest of Cosmos at full width, random weights from a seed: the image
   tokenizers DI16x16, CI16x16 and DI8x8 (channels 128 x (2, 4, 4)) written
   to encoder.jit / decoder.jit files and loaded back bitwise, then a
   seeded 1000 x 1000 uint8 image at B = 1 (padded and unpadded) through
   ImageTokenizer.forward and its encode, and for DI the array half of
   tokenize_images --save_codes (encode, _codes.npy, decode); CV8x8x8 and
   CV4x8x8 through ContinuousVideoTokenizer.forward on a seeded 33-frame
   256^2 clip (two windows); DV4x8x8 with the BASE encoder and decoder on
   one 17-frame window and the decode of its tokens.  Each in exact fp32
   and on TF32: ms per call, the tokens or latent elements TF32 moves,
   finite outputs; no attention kernel launches (Cosmos attends densely).
3h. The local model hub: the served EgoM2P-base written as a directory of
   config.json + model.safetensors (core/safetensors.py, no package), a
   directory of config.json + a .pth, and a bare .pth with the reference's
   pickled args, each loaded back by FM.from_pretrained(..., device="cuda"):
   every tensor bitwise served's (write and load seconds printed).  On the
   safetensors load, greedy rgb2depth at B = 8 with phase 3's greedy seed:
   216 flash64 launches, every token equal to served's; then
   forward_dec_subset_logits at SUBSET_ROWS chosen positions a row,
   bitwise equal to forward_mod_logits(forward_dec_subset_hidden(...)).
3i. The host tools, run right after 3c on its files: vis_3d/vis_cam.py's
   plot of the served rgb2cam (60, 9) path against 60 seeded c2w poses
   (the 1200^2 PNG decoded: each track's colour at its projected
   positions), vis_3d/cam_viz_tool.py's viewer with --save_rendering, the
   gaze overlay of the rgb2gaze (60, 2) track on a seeded (16, 256, 256, 3)
   uint8 clip (the array half; each frame the clip plus one radius-4
   disc), and examples/tok_{cam,gaze}_example.py on 3c's full-width .pth
   files (179.6M parameters each, exact fp32) over seeded 60 poses and a
   60-point gaze track, on the card and on the CPU: the 30 tokens in range
   and equal, the reconstruction finite and within HOST_TOOLS_ATOL of the
   CPU's; each step's seconds, tokenize / reconstruct ms, 0 kernel
   launches.
4. Training kernel phase at the pretraining step's shapes (B=8, 12 heads,
   N = M = 2048, q/k/v as views of fused projections): the flash64_train
   forward, dq and dk/dv kernels against their plain versions with key
   padding, segments (four modalities and -1 for masked positions), no mask,
   and a ragged N = M = 2000, in both softmax modes; then the flash-CE
   forward (wgmma, y streamed beside W, vocab split into S slices for small
   R) at R = 16384, D = 768, V = 64000 with every row and with half the rows
   live (dead rows exactly +inf / 0), at a vocab its tile does not divide,
   at D = 1024 and 2048, and split at R = 2048 and 512 (two runs bitwise
   equal).  Prints errors, S, kernel / plain times and the bound over the
   live rows, beside cuBLAS's y @ W^T alone.
5. Training slice, at full width: the port's trainer
   (egom2p_torch.cli.run_training.main) with cfgs/egom2p/main_mod4.yaml's
   settings as arguments (EgoM2P-base, 4 modalities in and out, 2048 + 2048
   tokens, batch 8, AdamW (0.9, 0.95), wd 0.05, clip 1.0) on synthetic
   data, constant LR, 6 steps: one warm-up, five timed.  Checks 36 forward,
   36 dq, 36 dk/dv and 2 flash-CE launches per step, finite losses and
   gradient norms, first-step losses near ln V and that every parameter
   moved; prints step time, tokens/s, peak memory and model FLOP/s.  Then a
   profiler trace of one step (device time by kernel class, idle share), each
   64k head's share of live rows on one batch and,
   on one batch, the loss and gradients with the kernels against the same
   model with the plain versions swapped in.
5b. Training on token shards, at full width: aligned tar shards of seeded
   tokens at the released shapes (tok_rgb and tok_depth 5 x 32 x 32, V =
   64000; tok_cam and tok_gaze 30, V = 256), 4 train shards of 16 samples
   and a held-out shard of 16, a JSON data config mirroring
   cfgs/egom2p/data_mod4.yaml with a `val` section, and the trainer at
   cfgs/egom2p/main_mod4.yaml's settings (the YAML files where PyYAML is
   installed, else JSON copies) with 2 forked loader workers (forked from
   this process, whose CUDA context is up), 2 epochs of 4 steps and 2 eval
   batches.  Checks 36 / 36 / 36 / 2 launches a step, finite losses near
   ln V, that every train batch holds train samples only and every eval
   batch held-out ones, 72 forward and 4 CE launches per validation pass
   and only the 4 CE launches per fixed-eval pass (128 + 128 tokens: the
   dense attention), the fixed-eval batches identical in both epochs and
   the val_* / fixed_eval_* losses in log.txt.  Prints the shard step's
   time beside phase 5's synthetic one, a profiled shard step with its
   data (device idle share), the loader alone in batches/s with 0 and 2
   workers; then --frozen_model_epochs 1: the trunk bitwise unchanged
   after epoch 0, every trunk tensor moved after epoch 1.
5c. Activation checkpointing: EgoM2P-base at B = 8 with
   --use_act_checkpoint true through the trainer (72 forward, 36 dq, 36
   dk/dv, 2 CE launches a step: the forward kernel runs again in each
   block's backward); on one batch and one set of weights, the loss and
   every gradient with remat none, full and dots bitwise equal, with their
   times, peak memory and launches, and the forward kernel run twice on
   the same inputs bitwise; then EgoM2P-large at B = 8 with remat full
   (144 stock forward and 72 stock backward launches a step), within the
   card's memory, every parameter moved.
5d. The tokenizer half of training, at full width, end to end into the
   trainer: the cam and gaze VQ-VAEs (dim 768, 12 + 12 blocks, latent 32,
   256 codes) trained through egom2p_torch.cli.run_training_vqvae.main at
   cfgs/vqvae/{cam,gaze}.yaml's settings (the YAML files where PyYAML is
   installed, else JSON copies in the script; B = 128, exact fp32) on 1024
   seeded trajectories each (smooth camera paths; gaze tracks with a
   validity channel): an epoch of 8 steps and eval, then a resume for a
   second.  Checks finite losses, every parameter and the codebook moved,
   codes expired and replaced, no kernel launch (30 tokens take the dense
   attention, as in JAX), the checkpoint loaded back bitwise through
   load_seq_vqvae_pth; prints step ms, samples/s, model FLOP/s against the
   FP32 peak, peak memory, the step on TF32 in turns with exact fp32, the
   tokens TF32 changes on a fixed batch and a profiled cam step.  Then --tokenize of 16 clip
   files on each trained checkpoint (the first through main(), the others
   through tokenize_file with the checkpoint loaded once; tokens equal the
   trained tokenizer's),
   tokenize_videos.write_batch on 16 staged seeded uint8 clips for rgb and
   depth at DV4x8x8's full width (ms per batch of 8; tokens read back from
   the tars equal forward's), the `-tok` rename, prepare_aligned_shards.py,
   and 2 EgoM2P-base steps at B = 8 on the result through
   cli/run_training's --data_config (36 / 36 / 36 / 2 launches a step,
   finite losses, each modality's first loss within CHAIN_LOSS_RTOL of the
   plain versions' forward on the same step: the cam / gaze targets come
   from briefly trained tokenizers, so ln V is not the loss to expect).
   Between them, the cam trainer on two gloo ranks sharing the card (this
   script spawns them), B = 64 a rank, one step on 128 samples, against
   one process at B = 128: the losses within FSDP_CE_RTOL, the codebook
   after the step (EMA statistics summed over the ranks), and the ranks'
   weights and codebook bitwise equal.
5e. The trainer across processes, EgoM2P-base at full width on synthetic
   data.  First one rank over NCCL, launched as users launch it (torchrun
   --standalone --nproc_per_node 1 with this script as the worker, which
   calls cli/run_training.main): 2 epochs of 3 steps at B = 8 with
   --profile, --async_save true and --save_ckpt_freq 1.  Checks the first
   step's loss and grad_norm bitwise equal to phase 5's single process,
   36 / 36 / 36 / 2 launches a step, a trace that names the four training
   kernels and checkpoint-0.pth (written on a background thread) bitwise
   the model and optimizer state at its step; prints the step ms beside
   phase 5's and the NCCL kernels' share of the profiled epoch.  Then two
   ranks sharing the card over gloo (this script spawns them with RANK,
   WORLD_SIZE and LOCAL_RANK=0; each forms the group, then calls main()),
   B = 4 per rank, 2 steps at --accum_steps 1 and a val pass, then 2 at 2:
   the first step's CE per target token within STEP_LOSS_RTOL and its
   summed gradients within STEP_GRAD_REL_L2 (relative L2) of one process
   stepping the global batch the two ranks' seeded loaders gave, the
   parameters bitwise equal on both ranks after every step, 36 / 36 / 36 /
   2 launches per micro-batch, and the val pass within STEP_LOSS_RTOL of
   one process's eval of the same rows.  Its step times are a correctness
   run's (two ranks on one card, gradients reduced through the host), not
   a scaling number.
5f. The trainer with --fsdp true (core/fsdp.py), EgoM2P-base at full width
   on synthetic data.  One rank over NCCL under torchrun, as phase 5e's
   (no profile): the first step's loss and grad_norm bitwise equal to
   phase 5's single process (a shard of one is the whole tensor), 36 /
   36 / 36 / 2 launches a step, the async checkpoint-0.pth bitwise the
   gathered state; the step ms beside phase 5's, the bytes held between
   steps and a step's peak.  Then two gloo ranks sharing the card, B = 4
   a rank, clipping off: data parallelism for FSDP_STEPS steps, then FSDP
   for FSDP_STEPS, checkpoint-0.pth (async) and FSDP_STEPS more; the
   gathered parameters equal on both ranks after every step, FSDP's after
   its first epoch against data parallelism's after the same batches
   (bitwise expected; the largest difference printed), an FSDP rank's
   parameters + Adam moments at most FSDP_PERSISTENT_SHARE of a
   data-parallel rank's and its last step's peak lower (a steady step: the
   first runs before Adam's moments exist); the first FSDP step's CE per
   target token within FSDP_CE_RTOL and its gradients within
   STEP_GRAD_REL_L2 of one process on the global batch; checkpoint-0.pth
   loaded in one process without FSDP bitwise equal to the ranks'
   gathered parameters, and stepped on the ranks' next global batch: CE
   per target token within FSDP_CE_RTOL of the ranks' next step.
5g. Training with captions, at full width: aligned tar shards as in 5b
   plus `.txt` captions of CAPTION_WORDS (2 train shards of 16, a held-out
   shard of 8), a data config with the five modalities in and out, an
   alphas config with the caption's keep schemes, --text_tokenizer_path
   naming the phase's tokenizer.json, main_mod4's settings (B = 8, 2048 +
   2048 tokens) and 2 workers: CAPTION_TRAIN_STEPS steps and an eval pass,
   24 / 24 / 24 flash64_train launches a step (encoder and cross-attention;
   the decoder's self-attention takes the dense cumsum mask) and 3 flash-CE
   forward launches (the two 64k heads and the caption's 30000), finite
   losses, each modality's first loss within 0.5 of ln V, every parameter
   moved (the caption's embeddings too), step ms, tokens/s and peak memory,
   a profiled step (device time by kernel class, idle share) and one
   batch's step with the kernels against the plain versions; then
   the causal registry model for CAUSAL_STEPS steps (finite, the same
   launches).
5h. The rgb video VQ-VAE at the CLI's video defaults (16 x 256 x 256 x 3,
   tubelet 2, patch 16, dim 768, 12 + 12 blocks of 12 heads, B = 8, exact
   fp32) through cli/run_training_vqvae.main on seeded .npy clips (24 clips,
   3 steps, the rgb augmentations), its eval with seeded RANDOM InceptionV3
   and LPIPS-VGG weight files written into EGOM2P_CKPT_DIR (the numbers are
   of random networks), the image log and --tokenize of 2 clips: step ms,
   clips/s, TFLOP/s against the FP32 peak, 24 / 24 / 24 forward / dq / dk-dv
   launches a step (2048 tokens, no mask); one step with the kernels
   against the plain versions (loss, gradients' relative L2); a profiled
   step (device time by kernel class, idle share); rows 3-5 at the step's
   shape (phase 4's no-mask 2048^2 case) beside their bounds and
   scaled_dot_product_attention.
5i. cfgs/vqvae/clip_b16.yaml (or its JSON copy CLIP_B16_CONFIG) at B = 64
   through the CLI on seeded 224 x 224 images with a random bf16 CLIP-B16
   teacher: steps and images/s, no kernel launch (197 and 196 tokens take
   the dense path); then one bf16 forward of a random DINOv2-B14 (12
   flash64_train forward launches at 257 tokens) and of a random
   ImageBind-H14 (32 stock-route forward launches, 16 heads of 80) at B =
   8, kernels against plain versions, and each attention kernel at that
   shape beside its plain version, bound and scaled_dot_product_attention.
5j. The gradient quantizers through the CLI: the rgb video VQ-VAE at 5h's
   settings with --quantizer_type taming, B = 8, 3 steps, no eval: step ms,
   clips/s, 24 / 24 / 24 forward / dq / dk-dv launches a step, finite
   losses, every parameter and the codebook moved, one step's loss and
   gradients with the kernels against the plain versions; then Memcodes on
   cam at cfgs/vqvae/cam.yaml's widths, B = 128, an epoch of 4 steps with
   eval, and --tokenize of 16 clips (no kernel launch).
5k. LoRA fine-tuning of EgoM2P-base (models/lora.py): rank 4 adapters on
   every attention linear (84), the base frozen, AdamW on the adapters,
   LORA_STEPS steps at B = 8 on phase 5's synthetic batch through
   lora_train_step_fn (torch.func.functional_call on the merged weights):
   36 / 36 / 36 / 2 launches a step, finite losses, the base weights
   bitwise unchanged, gradients on the adapters only (every b moved); the
   step ms beside phase 5's; the adapters' gradients with the kernels
   against the plain versions (phase 5's tolerances) and merge_lora + the
   model's own forward against the adapted forward (MERGE_LOSS_RTOL).
5l. The rgb video VQ-VAE of phase 5h on augmented clips: VideoClipDataset
   with auto_augment AUG_SPEC and random erasing (p = AUG_REPROB, per-pixel
   noise) over 5h's seeded .npy clips, made by VideoBatchLoader's
   AUG_WORKERS forked workers (data/rand_augment.py: torch on the host's
   CPU): the host's augmented clips/s alone, then AUG_STEPS steps at B = 8
   (24 / 24 / 24 launches a step) and their clips/s, one augmented batch's
   loss and gradients with the kernels against the plain versions.
5m. MultiModalDatasetFolder over seeded .npy rgb (uint8), depth (uint16),
   tok_rgb (4 stored crops) and crop_settings files, with
   UnifiedDataTransform, default_modality_transforms() (+ DepthTransform)
   and the pre-tokenized augmenter at 224 px: a stored random crop of
   each sample resized (data/resample.py, Pillow's arithmetic without
   Pillow); samples/s on the host, no kernel.  Prints whether Pillow and
   OpenCV import on the card's machine.
6. Fused-backward kernel phase at the same shapes: the fused one-pass
   dq/dk/dv kernel against its plain version with key padding and segments
   and at a ragged 2000^2, in both softmax modes; its time beside the split
   dq + dk/dv kernels' and the plain version's.
   Three fused runs give bitwise equal dk and dv.  Then the three backward
   kernels at ragged lengths on both sides of their 128-row blocks and
   64-row tiles, one row, 1707 and 2000, N != M too, with no mask, key padding
   (one batch row fully blocked: exact zeros) and segments, both softmax
   forms, at a small batch.
7. CE backward kernel phase: the fused CE backward kernel against the
   plain chunked backward at R = 16384, D = 768, V = 64000 with about half
   the rows at weight 0 (as in training), at R = 1000, V = 64007, and at
   the other column plans: D = 128, 384, 640, 1024, 2048.
8. Fused training run: the training slice again with
   EGOM2P_F64T_FUSED_BWD=1 and EGOM2P_CE_PALLAS_BWD=1 set for this phase
   only: 36 forward, 36 fused dq/dk/dv, 0 dq, 0 dk/dv, 2 CE forward and 2 CE
   backward launches per step, the same checks, its step time beside the
   default run's, and the one-batch kernels-vs-plain check.
9. Stock-route kernel phase: padding_flash_attention and
   segment_flash_attention (the forward kernel and the fused backward
   kernel at head_dim 80 for EgoM2P-large's heads of 68, and at 64)
   against their plain versions at B=8, N = M = 2048, with a fully blocked
   batch row, beside scaled_dot_product_attention at 68 and on the heads
   zero-padded to 80; the width-80 pair at ragged lengths around its tiles;
   the forward at a serving length, 8704^2, too.
10. One training step of the dim-1024 registry model egom2p_large_24e_24d_gelu
   at 2 + 2 blocks, batch 2, on four image-token modalities, with both
   flash-CE kernels (6/6/6 attention and 4 + 4 CE launches), against the
   same step on the plain versions.
11. EgoM2P-large training run, at full width and depth (24 + 24 layers, dim
   1020, 15 heads of 68, 2048 + 2048 tokens, batch 4): every
   attention on the stock route (72 forward and 72 backward launches per
   step, no flash64_train and no flash-CE launch: flash CE needs the model
   dim to be a multiple of 128), finite losses near ln V, every parameter
   moved; step time, tokens/s, peak memory, a profiled step and a one-batch
   kernels-vs-plain check.
12. Prints its seconds in all, the kernel JSON line (per kernel: launches
   on its main path, max error, kernel / plain / library times and the
   card's bound for the same work: the larger of its bytes at 3.35 TB/s and
   its operations at the dense bf16 peak), the card's name and power limit,
   and last the device JSON line.

`python3 chip_smoke.py --cards N` runs the trainer data-parallel over N
cards; `--cards N --fsdp` runs it with and without --fsdp true over N
cards (EgoM2P-base at B = 8 a card, EgoM2P-large at B = 8 with remat):
tokens/s per card, bytes per rank between steps and at a step's peak, the
collectives' share of a profiled run's kernel time.

Any failed check raises (nonzero exit, no device line).  Without a CUDA
device it exits with code 2 before doing anything.
"""
import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_STARTED = time.perf_counter()  # the script's seconds in all are printed from here

B = 8                      # clips per batch, as the rgb2depth bench
HEADS = 12
ATOL = RTOL = 1e-2         # bf16 output, same math summed in another order
CONTEXT_ATOL = 2e-2        # fp32 model, bf16 attention outputs through 12 layers
LAUNCHES_PER_GENERATE = (12 * 2 + 12 * 2 * 2) * 3
# training kernels, against their plain versions on the same inputs (max
# measured on an H100 in brackets): bf16 o within a bf16 ulp (3.9e-3); L2
# from fp32 sums in another order (1.9e-6); bf16 gradients with p and dS
# rounded to bf16 inside, against each gradient's max |ref| (2.0e-3 abs)
TRAIN_O_ATOL = 1e-2
TRAIN_L2_ATOL = 1e-4
TRAIN_GRAD_TOL = 1e-2
CE_LOGZ_RTOL = 1e-5            # fp32 logits and sums in another order (1.9e-6 abs)
CE_GOLD_ATOL = 1e-4
# one training step on a batch, bf16 activations, kernels vs plain versions: the
# same math in another order, amplified by the bf16 roundings downstream
# (loss 8.8e-6 relative; gradients 1.3e-2 relative L2)
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_REL_L2 = 3e-2        # |g_kernel - g_plain| / |g_plain| over all parameters
TRAIN_STEPS = 6                # --epoch_size 48 at batch 8
BF16_PEAK_TFLOPS = 989.0       # H100 SXM dense bf16, NVIDIA's data sheet
# CE backward kernel against the chunked backward: dl rounded to bf16 in
# both, fp32 sums of dy and dW in another order, against each one's max
CE_BWD_TOL = 1e-3
BASE_MODEL = "egom2p_base_12e_12d_swiglu_nobias"
LARGE_MODEL = "egom2p_large_24e_24d_swiglu_nobias"
LARGE_HEADS, LARGE_HD = 15, 68
# batch 8 runs out of the card's 80 GB at its second step (once AdamW's
# state exists); batch 4 peaks near 50 GiB (NVIDIA H100 80GB HBM3, 700 W)
LARGE_B = 4
# kernel launches per training step, by wrapper (see _wrappers)
DEFAULT_STEP = dict(fwd=36, dq=36, dkv=36, dqkv=0, ce_fwd=2, ce_bwd=0, stock_fwd=0, stock_bwd=0)
FUSED_STEP = dict(DEFAULT_STEP, dq=0, dkv=0, dqkv=36, ce_bwd=2)
LARGE_STEP = dict(fwd=0, dq=0, dkv=0, dqkv=0, ce_fwd=0, ce_bwd=0, stock_fwd=72, stock_bwd=72)
HBM_GB_PER_S = 3350.0          # H100 SXM device memory, NVIDIA's data sheet
SM_COUNT, EXP2_PER_SM_CLOCK = 132, 16   # H100 SXM; special-function results per SM per clock
SM_CLOCK_MHZ = 1980.0          # H100 SXM boost clock; main() takes the card's clocks.max.sm
# the forward kernel's tile edges: lengths on both sides of each, one row,
# and the main paths' ragged lengths
# where a gradient is rounding noise only (one live key: softmax's gradient is
# zero, the plain version leaves 5e-7), the relative tolerance needs a floor
RAGGED_GRAD_ATOL = 1e-5
RAGGED_SELF = (1, 63, 64, 65, 127, 128, 129, 1707, 2000)
# the eval phase: uint8 pixels TF32 may move against exact fp32 in the
# decode, and the clips each entry point takes (B = 1 per file, as the
# entry points run).  The card's machine has no libav (no libavformat for
# pkg-config, no headers), so the eval phase runs the entry points' per-clip
# work and the array half of the decode: the mp4 legs are held by the CPU
# tests (tests/test_torch_eval.py)
DECODE_PIXEL_LEVELS = 1
EVAL_FILES = 2
# the cam / gaze eval phase: flash64 launches per generate (12 encoder layers
# x 2 CFG branches x the task's steps: the decoder's 10 or 6 query rows a step
# take the dense path, 10 x 5376 < 256^2, in both packages), and rgb2cam's
# B = 1 encoder attention at its last steps (5120 + 10 or 20 visible tokens,
# bucketed to 5376)
SEQ_LAUNCHES = {"rgb2cam": 12 * 2 * 3, "rgb2gaze": 12 * 2 * 5}
SEQ_ENCODER_N, SEQ_ENCODER_LIVE = 5376, 5140
# the kernel at that shape against its plain version: the largest error (a
# bf16 ulp of |o|, 4.9e-4 read on an H100) and |got - ref| / |ref| over the
# whole output.  Leaving out the 20 live keys of the last, partial tile moves
# o by several percent in that norm; the check asserts that it would see that
SEQ_B1_ATOL = 2e-3
SEQ_B1_REL_L2 = 1e-2
# the host tools phase (3i): the gaze overlay's seeded clip, the gaze track's
# frames, and the examples' reconstruction on the card against the CPU's
# (exact fp32 both; the released width's fp32 bound against JAX on the CPU,
# tests/test_torch_seq_vqvae.py: FULL_WIDTH_ATOL)
HOST_CLIP = (16, 256, 256, 3)
HOST_FRAMES = 60
HOST_TOOLS_ATOL = 5e-5
RAGGED_CROSS = ((1, 129), (129, 1), (63, 2000), (2000, 65), (127, 128), (128, 127), (65, 1707))


def bound_ms(flops: float, nbytes: float):
    """The least time the card could take: (ms, "operations" or "bytes"),
    the larger of the operations at the dense bf16 peak and the bytes (each
    input read once, each output written once) at the device memory rate."""
    ops_ms = flops / BF16_PEAK_TFLOPS / 1e9
    bytes_ms = nbytes / HBM_GB_PER_S / 1e6
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def attention_bound_ms(products: int, b: int, heads: int, n: int, m: int, hd: int,
                       q_tensors: int = 2, kv_tensors: int = 2):
    """Bound of an attention kernel that runs `products` matrix products of
    n x m x hd per (batch, head) (forward 2, dq 3, dk/dv 4, fused backward
    5) and moves `q_tensors` bf16 tensors of n rows and `kv_tensors` of m
    rows (forward: q, o and k, v)."""
    flops = products * 2.0 * b * heads * n * m * hd
    nbytes = 2.0 * b * heads * hd * (q_tensors * n + kv_tensors * m)
    return bound_ms(flops, nbytes)


def exp2_bound_ms(b: int, heads: int, n: int, m: int, sm_clock_mhz: float) -> float:
    """The second bound of a head_dim-64 forward: one exp2 per score on the
    special function units, 16 results per SM per clock."""
    return b * heads * n * m / (SM_COUNT * EXP2_PER_SM_CLOCK * sm_clock_mhz * 1e3)


def ce_fwd_bound_ms(rows: int, dim: int, vocab: int):
    """One logits product; y and W read, two fp32 values per row written."""
    return bound_ms(2.0 * rows * dim * vocab, 2.0 * dim * (rows + vocab) + 8.0 * rows)


def ce_bwd_bound_ms(live_rows: int, rows: int, dim: int, vocab: int):
    """Three logits-sized products (logits, dy, dW) over the rows of nonzero
    weight; y and W read, fp32 dy and dW written."""
    return bound_ms(3 * 2.0 * live_rows * dim * vocab, (2.0 + 4.0) * dim * (rows + vocab))


def _sdpa_ms(qh, kh, vh, kvb=None, seg=None, backward=False, reps=5, scale=None,
             kernel_name=False):
    """Times of torch's scaled_dot_product_attention on head-major (B, H, L,
    hd) q/k/v with the boolean mask of the key padding or the segments (and
    the softmax scale `scale`, hd^-0.5 by default): (forward ms, backward ms
    or None, " (the longest device kernel's name)" when `kernel_name`, read
    from a profiled call, else "").  The backward is forward + backward
    through autograd minus the forward."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    mask = None
    if kvb is not None:
        mask = ~kvb.bool()[:, None, None, :]
    elif seg is not None:
        mask = (seg[:, :, None] == seg[:, None, :])[:, None]
    with torch.no_grad():
        fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,  # noqa: E731
                                                     scale=scale)
        fwd_ms = _cuda_time_ms(fwd, reps, 1)
        picked = ""
        if kernel_name:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fwd()
                torch.cuda.synchronize()
            kernels = [(e.time_range.end - e.time_range.start, e.name) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            picked = f" ({max(kernels)[1][:60] if kernels else 'kernel name not read'})"
    if not backward:
        return fwd_ms, None, picked
    leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
    do = torch.randn_like(qh)

    def both():
        for t in leaves:
            t.grad = None
        F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=scale).backward(do)

    return fwd_ms, _cuda_time_ms(both, reps, 1) - fwd_ms, picked


def _randn(rng, shape, dev):
    """A bf16 tensor of standard normal values drawn on the device by a torch
    generator seeded from the numpy generator `rng` (hundreds of millions of
    values a phase: drawn on the host they took seconds)."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def _split_heads(t, heads):
    return t.unflatten(-1, (heads, t.shape[-1] // heads)).transpose(1, 2)


def _rel_l2(got, ref) -> float:
    """|got - ref| / |ref| over the whole tensor, in fp32."""
    ref = ref.float()
    return ((got.float() - ref).norm() / ref.norm()).item()


def _cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def _env(**values):
    """Set environment switches for one phase and restore them after it."""
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _fused_views(rng, n_q, n_kv, dev, b=B):
    """q as a view of a (b, N, 3C) qkv projection, k/v as views of a
    (b, M, 2C) kv projection, the layouts the model hands the kernel."""
    C = HEADS * 64
    qkv, kv = _randn(rng, (b, n_q, 3 * C), dev), _randn(rng, (b, n_kv, 2 * C), dev)
    return qkv[..., :C], kv[..., :C], kv[..., C:]


def kernel_phase(dev):
    from egom2p_torch.ops.flash64 import flash64_attention, flash64_attention_reference

    # (name, N, M, number of live keys per row or None for no mask)
    cases = [("encoder cond step 3, 8704^2, key padding", 8704, 8704, 8534),
             ("encoder uncond step 1, 256^2, every key blocked", 256, 256, 0),
             ("decoder self-attention, 1707^2, no mask", 1707, 1707, None),
             ("decoder cross-attention, 1707x3584, key padding", 1707, 3584, 3414)]
    rng = np.random.default_rng(0)
    rows, max_err = [], 0.0
    for name, n_q, n_kv, live in cases:
        q, k, v = _fused_views(rng, n_q, n_kv, dev)
        blocked = None
        if live is not None:
            blocked = (torch.arange(n_kv, device=dev) >= live)[None].expand(B, -1).contiguous()
        lib_ms, _, picked = _sdpa_ms(*(_split_heads(t, HEADS) for t in (q, k, v)), blocked,
                                     kernel_name=not rows)
        bound, bound_by = attention_bound_ms(2, B, HEADS, n_q, n_kv, 64)
        print(f"flash64 {name}: bound {bound:.4f} ms ({bound_by}), exp2 bound "
              f"{exp2_bound_ms(B, HEADS, n_q, n_kv, SM_CLOCK_MHZ):.4f} ms at {SM_CLOCK_MHZ:.0f} MHz; "
              f"scaled_dot_product_attention {lib_ms:.4f} ms{picked}")
        for safemax in (False, True):
            out = flash64_attention(q, k, v, blocked, safemax=safemax)
            torch.cuda.synchronize()
            ref = flash64_attention_reference(q, k, v, blocked, safemax=safemax)
            err = (out.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
            if live == 0 and not bool((out == 0).all()):
                raise AssertionError(f"{name}: fully blocked rows are not exact zeros")
            ms = _cuda_time_ms(lambda: flash64_attention(q, k, v, blocked, safemax=safemax), 20)
            plain_ms = _cuda_time_ms(
                lambda: flash64_attention_reference(q, k, v, blocked, safemax=safemax), 3, 1)
            flops = 4.0 * B * HEADS * n_q * n_kv * 64
            mode = "safemax" if safemax else "clamp"
            print(f"flash64 {mode:7s} {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s)  plain {plain_ms:.4f} ms")
            rows.append({"case": name, "mode": mode, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms, "shape": (n_q, n_kv)})
            max_err = max(max_err, err)
        del q, k, v
    return rows, max_err


def ragged_phase(dev):
    """The forward kernel against its plain version at lengths around its
    128-row query tiles and 128-key stages: the training instance (o and
    L2) on self-attention views of one qkv projection with no mask, key
    padding (one batch row fully blocked) and segments with -1; the
    inference instance with N != M; fully blocked key stages before, between
    and after live ones.  Both softmax forms.  Returns the number of cases."""
    import egom2p_torch.ops.flash64_train as ft
    from egom2p_torch.ops.flash64 import flash64_attention, flash64_attention_reference

    b, heads = 2, 2
    C = heads * 64
    rng = np.random.default_rng(4)
    randn = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape, np.float32)).to(dev, torch.bfloat16)
    n_cases, worst = 0, 0.0
    for n in RAGGED_SELF:
        qkv = randn(b, n, 3 * C)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        kvb = torch.from_numpy(rng.uniform(size=(b, n)) < 0.3)
        kvb[1] = True
        ids = np.array([31433, 17061, 7210, -1], np.int32)
        seg = torch.from_numpy(ids[np.sort(rng.integers(0, 4, (b, n)), axis=1)]).to(dev)
        for mode, mk, sg in (("none", None, None), ("kp", kvb.to(dev), None), ("seg", None, seg)):
            for safemax in (False, True):
                o, l2 = ft.flash64_train_fwd(q, k, v, mk, sg, safemax)
                torch.cuda.synchronize()
                ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, mk, sg, safemax)
                err = (o.float() - ro.float()).abs().max().item()
                err_l2 = (l2 - rl2).abs().max().item()
                if err > TRAIN_O_ATOL or err_l2 > TRAIN_L2_ATOL:
                    raise AssertionError(f"ragged {n}^2 {mode} safemax={safemax}: o {err}, "
                                         f"L2 {err_l2}")
                if mode == "kp" and not ((o[1] == 0).all() and (l2[1] == 1e30).all()):
                    raise AssertionError(f"ragged {n}^2: a dead row is not zeros with L2 = 1e30")
                worst, n_cases = max(worst, err), n_cases + 1
    blocked_cases = [(nq, nk, None) for nq, nk in RAGGED_CROSS]
    blocked_cases += [(300, 512, [(0, 128), (256, 512)]), (300, 640, [(300, 310)])]
    for n_q, n_kv, live in blocked_cases:
        q, kv = randn(b, n_q, 3 * C)[..., :C], randn(b, n_kv, 2 * C)
        k, v = kv[..., :C], kv[..., C:]
        if live is None:
            blocked = torch.from_numpy(rng.uniform(size=(b, n_kv)) < 0.3)
            blocked[1] = True
        else:
            blocked = torch.ones((b, n_kv), dtype=torch.bool)
            for lo, hi in live:
                blocked[0, lo:hi] = False
        blocked = blocked.to(dev)
        for safemax in (False, True):
            out = flash64_attention(q, k, v, blocked, safemax=safemax)
            torch.cuda.synchronize()
            ref = flash64_attention_reference(q, k, v, blocked, safemax=safemax)
            torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
            if not (out[1] == 0).all():
                raise AssertionError(f"ragged {n_q}x{n_kv}: a dead row is not exact zeros")
            worst = max(worst, (out.float() - ref.float()).abs().max().item())
            n_cases += 1
    print(f"flash64 forward, ragged lengths {RAGGED_SELF} and {RAGGED_CROSS}, blocked stages: "
          f"{n_cases} cases, max_abs_err {worst:.3e}")
    return n_cases


def _rgb2depth_sample(tokens):
    from egom2p_torch.data.modality_info import MODALITY_INFO
    from egom2p_torch.generate.sampler import (init_empty_target_modality,
                                               init_full_input_modality)
    n = tokens.shape[0]
    sample = {"tok_rgb": {"tensor": tokens.reshape(n, -1)}}
    init_full_input_modality(sample, MODALITY_INFO, "tok_rgb")
    init_empty_target_modality(sample, MODALITY_INFO, "tok_depth", n, 5120)
    return sample


def context_check(model, tokens):
    """forward_enc_context at B=1 in fp32 with the kernel vs plain attention."""
    import egom2p_torch.ops.flash64 as f64
    from egom2p_torch.ops.attention import inference_attention

    md = {m: {k: torch.as_tensor(v).to(tokens.device) for k, v in d.items()}
          for m, d in _rgb2depth_sample(tokens[:1]).items()}
    kernel = f64.flash64_attention
    with torch.inference_mode(), inference_attention():
        ctx_kernel, _ = model.forward_enc_context(md, 5120, torch.float32)
        f64.flash64_attention = f64.flash64_attention_reference
        try:
            ctx_plain, _ = model.forward_enc_context(md, 5120, torch.float32)
        finally:
            f64.flash64_attention = kernel
    err = (ctx_kernel - ctx_plain).abs().max().item()
    print(f"encoder context, B=1 fp32, kernel vs plain attention: max_abs_err {err:.3e}")
    if not torch.isfinite(ctx_kernel).all() or err > CONTEXT_ATOL:
        raise AssertionError(f"encoder context disagrees with plain attention: {err}")


def slice_phase(dev):
    from egom2p_torch.cli import eval_common
    from egom2p_torch.generate.sampler import GenerationSampler
    from egom2p_torch.ops.flash64 import flash64_attention

    args = argparse.Namespace(model="egom2p_base_12e_12d_swiglu_nobias", seed=0, smoke=True)
    t0 = time.perf_counter()
    model = eval_common.load_main_model(args, dev)
    tokenizer = eval_common.load_video_tokenizer(args, dev)
    sampler = GenerationSampler(model)
    torch.cuda.synchronize()
    print(f"model + tokenizer init: {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M + "
          f"{sum(p.numel() for p in tokenizer.net.parameters()) / 1e6:.1f}M params")
    schedule = eval_common.roar_schedule("tok_rgb", "tok_depth")
    # uint8 clips staged on the device ahead of the timed region, as the bench does
    clips = np.random.default_rng(0).integers(0, 256, (B, 16, 256, 256, 3), dtype=np.uint8)
    video = torch.from_numpy(clips).to(dev)

    finite = []
    hooks = [m.register_forward_hook(lambda _m, _i, out: finite.append(torch.isfinite(out).all()))
             for m in (model.encoder_norm, model.decoder_norm)]

    def run(seed):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        tokens = tokenizer.forward(video, device_out=True)
        torch.cuda.synchronize()
        t_tok = time.perf_counter()
        out = sampler.generate(_rgb2depth_sample(tokens), schedule, top_p=0.8, top_k=0.0,
                               seed=seed)
        torch.cuda.synchronize()
        return tokens, out, t_tok - t_start, time.perf_counter() - t_tok

    run(seed=100)  # warm-up: cuDNN algorithm choice, allocator growth
    times, launches = [], None
    for rep in range(3):
        finite.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        flash64_attention.launches = 0
        tokens, out, tok_s, gen_s = run(seed=rep)
        launches = flash64_attention.launches
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(f"slice run {rep}: tokenize {tok_s * 1e3:.1f} ms, generate {gen_s * 1e3:.1f} ms, "
              f"{B / (tok_s + gen_s):.3f} clips/s, flash64 launches {launches}, "
              f"peak memory {peak_gib:.2f} GiB")
        times.append((tok_s, gen_s))
        if launches != LAUNCHES_PER_GENERATE:
            raise AssertionError(f"flash64 launched {launches} times, expected "
                                 f"{LAUNCHES_PER_GENERATE}")
        if not finite or not all(bool(f) for f in finite):
            raise AssertionError("non-finite hidden states in the encoder or decoder")
        depth = out["tok_depth"]["tensor"]
        if tuple(tokens.shape) != (B, 5, 32, 32) or depth.shape != (B, 5120):
            raise AssertionError(f"token shapes {tuple(tokens.shape)}, {depth.shape}")
        for name, t in (("rgb", tokens.cpu().numpy()), ("depth", depth)):
            if t.min() < 0 or t.max() >= 64000:
                raise AssertionError(f"{name} tokens outside [0, 64000)")
        if not out["tok_depth"]["target_mask"].all():
            raise AssertionError("not every depth position was generated")
    for h in hooks:
        h.remove()
    context_check(model, tokens)
    tok_ms = float(np.median([t for t, _ in times]) * 1e3)
    gen_ms = float(np.median([g for _, g in times]) * 1e3)
    print(f"slice median: tokenize {tok_ms:.1f} ms, generate {gen_ms:.1f} ms, "
          f"{B / (tok_ms + gen_ms) * 1e3:.3f} clips/s")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, tok_s, gen_s = run(seed=4)
    _device_breakdown(prof, "batch", (tok_s + gen_s) * 1e3, tok_ms + gen_ms)
    # one more run with the running-max softmax (the inference kernel's
    # other form, EGOM2P_F64_SAFEMAX=1), counted on its own
    with _env(EGOM2P_F64_SAFEMAX="1"):
        flash64_attention.launches = 0
        _, out, tok_s, gen_s = run(seed=3)
        safemax_launches = flash64_attention.launches
    print(f"slice run, safemax softmax: generate {gen_s * 1e3:.1f} ms, flash64 launches "
          f"{safemax_launches}")
    if safemax_launches != LAUNCHES_PER_GENERATE or not out["tok_depth"]["target_mask"].all():
        raise AssertionError(f"safemax run: {safemax_launches} launches")
    greedy = head_check(model, sampler, tokens)
    encode_tf32_check(tokenizer, video)
    served = dict(model=model, sampler=sampler, tokenizer=tokenizer, video=video,
                  rgb=tokens, depth=out["tok_depth"]["tensor"], greedy_depth=greedy)
    return launches, safemax_launches, B / (tok_ms + gen_ms) * 1e3, served


def head_check(model, sampler, tokens):
    """Greedy rgb2depth on the served batch twice: with the generation head's
    product on TF32 (forward_logits: bf16 values, exact in TF32) and with the
    full fp32 product.  The tokens must be equal."""
    from egom2p_torch.cli.eval_common import roar_schedule
    from egom2p_torch.models import embeddings

    schedule = roar_schedule("tok_rgb", "tok_depth", temperature=0.0)
    tf32 = sampler.generate(_rgb2depth_sample(tokens), schedule, seed=5)["tok_depth"]["tensor"]
    real = embeddings.matmul_f32
    embeddings.matmul_f32 = lambda a, b, bf16_values=None: torch.matmul(a.float(), b.float())
    try:
        fp32 = sampler.generate(_rgb2depth_sample(tokens), schedule, seed=5)["tok_depth"]["tensor"]
    finally:
        embeddings.matmul_f32 = real
    unequal = int((np.asarray(tf32) != np.asarray(fp32)).sum())
    print(f"generation head on TF32 (bf16 values) vs the full fp32 product, greedy "
          f"rgb2depth on the served batch: {unequal} unequal tokens of {np.asarray(fp32).size}")
    if unequal:
        raise AssertionError(f"the TF32 generation head changed {unequal} greedy tokens")
    return np.asarray(tf32)


def _median_ms(fn, reps: int = 3):
    """fn() once to warm up (cuDNN's algorithm choice, the allocator), then
    the median wall time of `reps` calls between device synchronizations,
    and the last call's result."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def encode_tf32_check(tokenizer, video):
    """The served batch tokenized with the encoder's fp32 convs and products
    on TF32 and in exact fp32.  TF32 may be the tokenizer's setting
    (video_api.ENCODE_TF32) only if no token differs."""
    from egom2p_torch.tokenizers.cosmos import video_api

    ms, tokens = {}, {}
    for tf32 in (True, False):
        tokenizer.encode_tf32 = tf32
        ms[tf32], tokens[tf32] = _median_ms(lambda: tokenizer.forward(video, device_out=True))
    tokenizer.encode_tf32 = video_api.ENCODE_TF32
    unequal = int((tokens[True] != tokens[False]).sum())
    print(f"tokenizer encode, B={B}: TF32 {ms[True]:.1f} ms, exact fp32 {ms[False]:.1f} ms; "
          f"{unequal} of {tokens[False].numel()} tokens differ; the encode runs "
          f"{'on TF32' if video_api.ENCODE_TF32 else 'in exact fp32'}")
    if video_api.ENCODE_TF32 and unequal:
        raise AssertionError(f"TF32 changed {unequal} tokens: the encode must run in exact fp32")


def decode_phase(tokenizer, depth):
    """The served batch's depth tokens through the Cosmos decoder: fp32
    video (B, 17, 256, 256, 3), finite; then the array half of the eval
    decode, uint8 (B, 16, 256, 256, 3) in gray.  Decoded with the decoder's
    fp32 products on TF32 and in exact fp32: TF32 may be the tokenizer's
    setting (video_api.DECODE_TF32) only if no uint8 pixel moves by more
    than DECODE_PIXEL_LEVELS."""
    from egom2p_torch.generate.decode import decode_video_tokens
    from egom2p_torch.tokenizers.cosmos import video_api

    net = tokenizer.net
    idx = torch.as_tensor(depth).to(tokenizer.device).reshape(B, 5, 32, 32)
    ms, pixels = {}, {}
    for tf32 in (True, False):
        tokenizer.decode_tf32 = tf32
        ms[tf32], rec = _median_ms(lambda: tokenizer.decode(idx))
        pixels[tf32] = video_api.tensor2uint8(rec)
    tokenizer.decode_tf32 = video_api.DECODE_TF32
    moved = int(((pixels[True].int() - pixels[False].int()).abs() > DECODE_PIXEL_LEVELS).sum())
    torch.cuda.reset_peak_memory_stats()
    rec = tokenizer.decode(idx)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if tuple(rec.shape) != (B, 17, 256, 256, 3) or rec.dtype != torch.float32:
        raise AssertionError(f"decoded {tuple(rec.shape)} {rec.dtype}")
    if not torch.isfinite(rec).all():
        raise AssertionError("non-finite decoded video")
    n_dec = sum(p.numel() for m in (net.post_quant_conv, net.decoder) for p in m.parameters())
    decode_ms = ms[video_api.DECODE_TF32]
    print(f"cosmos decode, B={B} x 5x32x32 tokens -> {tuple(rec.shape)} fp32: TF32 "
          f"{ms[True]:.1f} ms, exact fp32 {ms[False]:.1f} ms; {moved} of {pixels[True].numel()} "
          f"uint8 values move by more than {DECODE_PIXEL_LEVELS}; the decode runs "
          f"{'on TF32' if video_api.DECODE_TF32 else 'in exact fp32'} ({decode_ms:.1f} ms); "
          f"peak memory {peak_gib:.2f} GiB; decoder {n_dec / 1e6:.1f}M params")
    if video_api.DECODE_TF32 and moved:
        raise AssertionError(f"TF32 moved {moved} pixels: the decode must run in exact fp32")
    frames = decode_video_tokens(depth, tokenizer, "tok_depth")
    if frames.shape != (B, 16, 256, 256, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"decoded frames {frames.shape} {frames.dtype}")
    if not ((frames[..., :1] == frames).all() and frames.std() > 0):
        raise AssertionError("decoded depth is not gray, or flat")
    return decode_ms


def _reference_checkpoints(model, tokenizer, directory):
    """The smoke EgoM2P-base in the reference's .pth layout (the state dict
    with its persistent pos_emb buffers, the argparse namespace naming the
    model and domains) and the Cosmos network's state dict."""
    from egom2p_torch.cli.eval_common import MODS4

    sd = dict(model.state_dict())
    sd.update({k: v for k, v in model.named_buffers() if k.endswith(".pos_emb")})
    ckpt = os.path.join(directory, "egom2p-base.pth")
    torch.save({"model": sd, "args": argparse.Namespace(
        model=BASE_MODEL, in_domains=list(MODS4), out_domains=list(MODS4))}, ckpt)
    cosmos = os.path.join(directory, "cosmos-dv4x8x8.pth")
    torch.save(tokenizer.net.state_dict(), cosmos)
    return ckpt, cosmos


def eval_phase(dev, served, tmp):
    """The eval path at full width on checkpoint files: decode of the served
    batch, the reference-format checkpoints written to `tmp` and loaded back
    through cli/eval_common without --smoke (greedy rgb2depth bitwise equal
    to the in-memory model's), then both entry points' work per clip on
    them.  Returns the EgoM2P-base .pth's path with the results."""
    from egom2p_torch.cli import eval_common
    from egom2p_torch.generate.decode import decode_video_tokens
    from egom2p_torch.ops.flash64 import flash64_attention

    t_phase = time.perf_counter()
    decode_ms = decode_phase(served["tokenizer"], served["depth"])
    out = {"decode_ms": decode_ms, "launches": {}}
    t0 = time.perf_counter()
    ckpt, cosmos = _reference_checkpoints(served["model"], served["tokenizer"], tmp)
    out["ckpt"] = ckpt
    print(f"reference-format checkpoints written: {time.perf_counter() - t0:.1f} s, "
          f"{os.path.getsize(ckpt) / 2 ** 30:.2f} GiB + "
          f"{os.path.getsize(cosmos) / 2 ** 20:.0f} MiB")
    argv = ["--ckpt", ckpt, "--video-tok-ckpt", cosmos, "--device", "cuda"]
    t0 = time.perf_counter()
    sampler, tokenizers, _ = eval_common.load_task(
        "rgb2depth", eval_common.build_argparser("rgb2depth").parse_args(argv))
    tokenizer = tokenizers["tok_vid"]
    torch.cuda.synchronize()
    print(f"loaded back through eval_common (no --smoke): {time.perf_counter() - t0:.1f} s")
    greedy = eval_common.roar_schedule("tok_rgb", "tok_depth", temperature=0.0)
    clip = served["video"][:1]
    kept = served["tokenizer"].forward(clip, device_out=True)
    loaded = tokenizer.forward(clip, device_out=True)
    gen = [s.generate(_rgb2depth_sample(t), greedy, seed=5)["tok_depth"]["tensor"]
           for s, t in ((served["sampler"], kept), (sampler, loaded))]
    if not torch.equal(kept, loaded) or not np.array_equal(*gen):
        raise AssertionError("the checkpoints loaded back give other tokens")
    print(f"checkpoint round trip, greedy rgb2depth of one clip: tokens bitwise equal "
          f"({kept.numel()} rgb, {gen[0].size} depth)")
    del sampler, tokenizers, tokenizer
    # the entry points' per-clip work, with no mp4 read or written (no
    # libav on the card's machine)
    for task in ("rgb2depth", "depth2rgb"):
        t = eval_common.TASKS[task]
        args = eval_common.build_argparser(task).parse_args(argv)
        sampler, tokenizers, schedule = eval_common.load_task(task, args)
        tokenizer = tokenizers["tok_vid"]
        for i in range(EVAL_FILES):
            clip = np.random.default_rng(10 + i).integers(0, 256, (1, 16, 256, 256, 3),
                                                          dtype=np.uint8)
            flash64_attention.launches = 0
            res, seconds = eval_common.run_clip(clip, sampler, tokenizer, schedule, t.cond,
                                                t.target, seed=args.seed)
            launches = flash64_attention.launches
            t0 = time.perf_counter()
            frames = decode_video_tokens(res[t.target]["tensor"], tokenizer, t.target)
            seconds["decode_s"] = time.perf_counter() - t0
            print(f"{task} clip {i}: tokenize {seconds['tokenize_s']:.3f} s, generate "
                  f"{seconds['generate_s']:.3f} s, decode {seconds['decode_s']:.3f} s, "
                  f"flash64 launches {launches}")
            if launches != LAUNCHES_PER_GENERATE:
                raise AssertionError(f"{task}: flash64 launched {launches} times")
            gray = bool((frames[..., :1] == frames).all())
            if frames.shape != (1, 16, 256, 256, 3) or gray != (t.target == "tok_depth"):
                raise AssertionError(f"{task}: frames {frames.shape}, gray {gray}")
            out["launches"][task] = launches
            out[task] = seconds
        del sampler, tokenizers, tokenizer
    print(f"eval phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def seq_round_trip(tokenizer):
    """Tokenize -> decode of seeded camera paths at B = 8 and B = 1, with the
    tokenizer's fp32 products exact and on TF32: ms per call, the tokens TF32
    changes and its largest change to the decoded values (information for
    later work: the tokenizer stays exact fp32, the JAX default), and ATE /
    RTE / RRE against the input (finite; meaningless with random weights)."""
    from egom2p_torch.data.cam_gaze import evaluate_9d_trajectory
    from egom2p_torch.data.cam_gaze import smooth_cam_trajectories
    from egom2p_torch.generate.decode import decode_cam_tokens

    x, gt = smooth_cam_trajectories(np.random.default_rng(20), B)
    x = torch.from_numpy(x).to(tokenizer.device)
    out = {}
    for b in (B, 1):
        ms, toks, rec = {}, {}, {}
        for tf32 in (False, True):
            tokenizer.tf32 = tf32
            ms[f"tokenize_{tf32}"], toks[tf32] = _median_ms(lambda: tokenizer.tokenize(x[:b]))
            ms[f"decode_{tf32}"], rec[tf32] = _median_ms(
                lambda: tokenizer.decode_tokens(toks[False]))
        tokenizer.tf32 = False
        if tuple(toks[False].shape) != (b, 30) or not 0 <= int(toks[False].min()) <= \
                int(toks[False].max()) < 256:
            raise AssertionError(f"cam tokens {tuple(toks[False].shape)} out of shape or range")
        if tuple(rec[False].shape) != (b, 60, 9) or not torch.isfinite(rec[False]).all():
            raise AssertionError(f"decoded cam {tuple(rec[False].shape)}, or not finite")
        changed = int((toks[True] != toks[False]).sum())
        moved = (rec[True] - rec[False]).abs().max().item()
        print(f"cam tokenizer, B={b}: tokenize exact fp32 {ms['tokenize_False']:.2f} ms, TF32 "
              f"{ms['tokenize_True']:.2f} ms ({changed} of {toks[False].numel()} tokens "
              f"differ); decode exact {ms['decode_False']:.2f} ms, TF32 "
              f"{ms['decode_True']:.2f} ms (largest change {moved:.3e})")
        out[b] = dict(ms, tf32_tokens_changed=changed, tf32_max_change=moved)
    pred = decode_cam_tokens(toks[False], tokenizer)
    metrics = evaluate_9d_trajectory(pred[0], gt[0])
    print(f"cam round trip of clip 0 (random weights): " +
          ", ".join(f"{k} {v:.4g}" for k, v in metrics.items()))
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite trajectory metrics {metrics}")
    return out


def seq_eval_phase(dev, served, tmp, ckpt):
    """rgb2cam and rgb2gaze at full width on checkpoint files (the module
    docstring, 3c).  `ckpt`: the eval phase's EgoM2P-base .pth in `tmp`."""
    from egom2p_torch.cli import eval_common, eval_model_rgb2cam, eval_model_rgb2gaze
    from egom2p_torch.core.checkpoint import save_seq_vqvae_pth
    from egom2p_torch.generate.decode import decode_cam_tokens
    from egom2p_torch.ops.flash64 import flash64_attention, flash64_attention_reference
    from egom2p_torch.tokenizers.seq_vqvae import seq_vqvae_from_config

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    kept, paths = {}, {}
    for i, domain in enumerate(("cam", "gaze")):
        kept[domain] = seq_vqvae_from_config(
            domain, torch.Generator(device=dev).manual_seed(30 + i), device=dev)
        paths[domain] = save_seq_vqvae_pth(kept[domain],
                                           os.path.join(tmp, f"checkpoint-{domain}.pth"))
    argv = ["--ckpt", ckpt, "--cam-tok-ckpt", paths["cam"], "--gaze-tok-ckpt", paths["gaze"],
            "--device", "cuda"]
    args = eval_common.build_argparser("rgb2cam").parse_args(argv)
    loaded = {d: eval_common.load_seq_tokenizer(args, d, dev) for d in paths}
    for d in paths:
        if any(not torch.equal(v, loaded[d].net.state_dict()[k])
               for k, v in kept[d].net.state_dict().items()):
            raise AssertionError(f"the {d} tokenizer loaded back differs")
    n_params = sum(p.numel() for p in kept["cam"].net.parameters())
    print(f"cam / gaze tokenizers: {n_params / 1e6:.1f}M params each, written and loaded "
          f"back in {time.perf_counter() - t0:.1f} s ({os.path.getsize(paths['cam']) / 2 ** 20:.0f} "
          f"+ {os.path.getsize(paths['gaze']) / 2 ** 20:.0f} MiB)")
    out = {"round_trip": seq_round_trip(loaded["cam"]), "launches": {}}

    # the entry points in full over npz files of the served clips' rgb tokens,
    # the launches counted around each generate
    data = os.path.join(tmp, "seq_data")
    os.makedirs(data)
    rgb = served["rgb"].reshape(B, -1).cpu().numpy()
    for i in range(EVAL_FILES):
        for task in ("rgb2cam", "rgb2gaze"):
            np.savez(os.path.join(data, f"{task}_{i}.npz"), rgb[i])
    per_generate = []
    run_tokens = eval_common.run_tokens

    def counted(*a, **kw):
        flash64_attention.launches = 0
        res = run_tokens(*a, **kw)
        per_generate.append(flash64_attention.launches)
        return res

    eval_common.run_tokens = counted
    try:
        for task, entry, shape in (("rgb2cam", eval_model_rgb2cam, (60, 9)),
                                   ("rgb2gaze", eval_model_rgb2gaze, (60, 2))):
            per_generate.clear()
            t0 = time.perf_counter()
            records = entry.main(argv + ["--data", data, "--out", os.path.join(tmp, "seq_out")])
            total_s = time.perf_counter() - t0
            for rec, launches in zip(records, per_generate):
                arr = np.load(rec["outputs"][eval_common.TASKS[task].target])
                print(f"{task} {rec['file']}: generate {rec['generate_s']:.3f} s, decode "
                      f"{rec['decode_s']:.4f} s, flash64 launches {launches}, .npy {arr.shape}")
                if arr.shape != shape or not np.isfinite(arr).all():
                    raise AssertionError(f"{task}: .npy {arr.shape}, finite "
                                         f"{np.isfinite(arr).all()}")
            if len(records) != EVAL_FILES or per_generate != [SEQ_LAUNCHES[task]] * EVAL_FILES:
                raise AssertionError(f"{task}: {len(records)} files, flash64 launches "
                                     f"{per_generate}, expected {SEQ_LAUNCHES[task]} each")
            print(f"{task} main(): {total_s:.1f} s with its loads")
            out["launches"][task] = per_generate[0]
            out[task] = records
    finally:
        eval_common.run_tokens = run_tokens
    # what the host tools phase (3i) reads: each task's first .npy and the tokenizers' .pth
    out["files"] = {"cam": out["rgb2cam"][0]["outputs"][eval_common.TASKS["rgb2cam"].target],
                    "gaze": out["rgb2gaze"][0]["outputs"][eval_common.TASKS["rgb2gaze"].target],
                    "cam_ckpt": paths["cam"], "gaze_ckpt": paths["gaze"]}

    # greedy rgb2cam of one clip: the loaded files against the in-memory models
    sampler, tokenizers, _ = eval_common.load_task("rgb2cam", args)
    greedy = eval_common.roar_schedule("tok_rgb", "tok_cam", 3, temperature=0.0)
    cond = served["rgb"][:1].reshape(1, -1)
    gen = [eval_common.run_tokens(cond, s, greedy, "tok_rgb", "tok_cam", seed=5)[0]
           ["tok_cam"]["tensor"] for s in (served["sampler"], sampler)]
    traj = [decode_cam_tokens(g, tok) for g, tok in zip(gen, (kept["cam"], tokenizers["tok_cam"]))]
    if not np.array_equal(*gen) or not np.array_equal(*traj):
        raise AssertionError("the cam checkpoints loaded back give other tokens or poses")
    print(f"checkpoint round trip, greedy rgb2cam of one clip: {gen[0].size} cam tokens and "
          f"the (60, 9) trajectory bitwise equal")
    del sampler, tokenizers

    # generate on the served batch's rgb tokens at B = 1 and B = 8: launches,
    # the median of 3 runs and, for rgb2cam, one profiled run (device time by
    # kernel class, idle share; rgb2gaze runs the same step with fewer rows,
    # and each profile's host-side processing takes seconds)
    from torch.profiler import ProfilerActivity, profile
    for b in (1, B):
        cond = served["rgb"][:b].reshape(b, -1)
        for task in ("rgb2cam", "rgb2gaze"):
            t = eval_common.TASKS[task]
            schedule = eval_common.roar_schedule(t.cond, t.target, t.steps)
            run = lambda: eval_common.run_tokens(cond, served["sampler"], schedule,  # noqa: E731
                                                 t.cond, t.target)
            flash64_attention.launches = 0
            res, _ = run()
            launches = flash64_attention.launches
            toks = res[t.target]["tensor"]
            if launches != SEQ_LAUNCHES[task] or toks.shape != (b, 30) or \
                    not res[t.target]["target_mask"].all() or toks.min() < 0 or toks.max() >= 256:
                raise AssertionError(f"{task} B={b}: {launches} launches, tokens {toks.shape}")
            ms, _ = _median_ms(run)
            print(f"{task} generate, B={b}: {ms:.1f} ms per batch (median of 3), flash64 "
                  f"launches {launches}")
            out[f"{task}_b{b}_ms"] = ms
            if task == "rgb2cam":
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    _, generate_s = run()
                _device_breakdown(prof, f"{task} generate B={b}", generate_s * 1e3, ms)

    # the kernel at rgb2cam's B = 1 encoder shape, beside its bound (over the
    # live keys), its plain version and the library call
    rng = np.random.default_rng(40)
    n, live = SEQ_ENCODER_N, SEQ_ENCODER_LIVE
    q, k, v = _fused_views(rng, n, n, dev, b=1)
    blocked = (torch.arange(n, device=dev) >= live)[None]
    got = flash64_attention(q, k, v, blocked)
    ref = flash64_attention_reference(q, k, v, blocked)
    err = (got.float() - ref.float()).abs().max().item()
    rel = _rel_l2(got, ref)
    # what the plain version gives when the partial tile's live keys are dropped
    tile_rel = _rel_l2(flash64_attention_reference(
        q, k, v, (torch.arange(n, device=dev) >= live // 64 * 64)[None]), ref)
    print(f"flash64 at {n}^2, {live} live keys vs plain: max_abs_err {err:.3e} (tolerance "
          f"{SEQ_B1_ATOL:g}), relative L2 {rel:.3e} (tolerance {SEQ_B1_REL_L2:g}; dropping "
          f"keys {live // 64 * 64}-{live - 1} gives {tile_rel:.3e})")
    if err > SEQ_B1_ATOL or rel > SEQ_B1_REL_L2:
        raise AssertionError(f"flash64 at rgb2cam's B=1 shape: max_abs_err {err}, rel L2 {rel}")
    if tile_rel <= 2 * SEQ_B1_REL_L2:
        raise AssertionError(f"the check cannot see the partial tile: {tile_rel}")
    ms = _cuda_time_ms(lambda: flash64_attention(q, k, v, blocked), 20)
    plain_ms = _cuda_time_ms(lambda: flash64_attention_reference(q, k, v, blocked), 3, 1)
    lib_ms, _, _ = _sdpa_ms(*(_split_heads(t, HEADS) for t in (q, k, v)), blocked)
    bound, bound_by = attention_bound_ms(2, 1, HEADS, n, live, 64)
    print(f"flash64 at rgb2cam's B=1 encoder shape, {n}^2, {live} live keys: max_abs_err "
          f"{err:.3e}, kernel {ms:.4f} ms, bound {bound:.4f} ms ({bound_by}), "
          f"scaled_dot_product_attention {lib_ms:.4f} ms, plain {plain_ms:.4f} ms")
    out["b1"] = {"shape": [1, HEADS, n, n], "live_keys": live, "max_abs_err": err,
                 "rel_l2": rel, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                 "library_ms": lib_ms}
    print(f"cam / gaze eval phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def host_tools_phase(dev, files, tmp):
    """The visualisers and the tokenizer examples on the cam / gaze eval
    phase's outputs and tokenizer files (the module docstring, 3i)."""
    from egom2p_torch.cli import run_training_vqvae
    from egom2p_torch.data.cam_gaze import cam_9d_to_mat, smooth_cam_trajectories
    from egom2p_torch.examples import tok_cam_example, tok_gaze_example
    from egom2p_torch.ops.flash64 import flash64_attention
    from egom2p_torch.vis_3d import cam_viz_tool, render, vis_cam, vis_gaze

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "host_tools")
    os.makedirs(root)
    rng = np.random.default_rng(50)
    mats = cam_9d_to_mat(smooth_cam_trajectories(rng, 1)[1][0])
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    first = np.eye(4)
    first[:3, :3], first[:3, 3] = q * np.sign(np.linalg.det(q)), rng.normal(size=3)
    poses = os.path.join(root, "cam.npy")        # 60 c2w poses off the origin
    np.save(poses, first @ mats)
    track = np.stack([rng.uniform(220, 680, HOST_FRAMES), rng.uniform(20, 480, HOST_FRAMES)], 1)
    track[[3, 17, 40]] = np.nan                  # 896 x 504 px, blinks
    gaze_px = os.path.join(root, "gaze.npy")
    np.save(gaze_px, track)
    flash64_attention.launches = 0
    _reset_counts()
    seconds = {}

    # the trajectory plot: the served rgb2cam path against the seeded poses
    t0 = time.perf_counter()
    png = os.path.join(root, "trajectory.png")
    tracks, limits = vis_cam.plot_trajectories(vis_cam.load_traj(files["cam"]),
                                               vis_cam.load_traj(poses), png)
    seconds["vis_cam"] = time.perf_counter() - t0
    img = render.read_png(png)
    # the view against matplotlib's default (elevation 30, azimuth -60), worked
    # by hand: a box-side step along x, y, z moves the screen point right / down
    # by (cos 30, sin 30 sin 30), (sin 30, -cos 30 sin 30), (0, -cos 30) scales
    unit = np.array([[0.0, 1.0]] * 3)
    steps = render.project(np.eye(3), unit) - render.project(np.zeros((1, 3)), unit)
    view = np.array([[0.75 ** 0.5, 0.25], [0.5, -0.1875 ** 0.5], [0.0, -0.75 ** 0.5]])
    if not np.allclose(steps / np.linalg.norm(steps[2]) * 0.75 ** 0.5, view):
        raise AssertionError(f"render.project: axis steps {steps.tolist()}, not matplotlib's view")
    for tr in tracks:
        xy = np.rint(render.project(tr.positions, limits)).astype(int)
        hit = (img[xy[:, 1], xy[:, 0]] == render.rgb(tr.color)).all(-1).mean()
        print(f"vis_cam {tr.label}: {hit:.0%} of its 60 projected positions hold {tr.color}")
        if img.shape != (render.SIZE, render.SIZE, 3) or hit < 0.5:
            raise AssertionError(f"trajectory.png {img.shape}: {tr.label} at {hit:.0%}")

    # the viewer and its rendering
    t0 = time.perf_counter()
    html = cam_viz_tool.main(["--recon", files["cam"], "--gt", poses, "--output",
                              os.path.join(root, "viz"), "--save_rendering"])
    seconds["cam_viz_tool"] = time.perf_counter() - t0
    with open(html) as f:
        data = json.loads(f.read().split("const DATA = ")[1].split(";\n")[0])
    viz = render.read_png(os.path.join(root, "viz", "cam_viz.png"))
    if (len(data["est"]["traj"]), len(data["gt"]["frusta"])) != (60, 60) or \
            viz.shape != (render.SIZE, render.SIZE, 3) or \
            not (viz == render.rgb("#d62728")).all(-1).any():
        raise AssertionError("cam_viz.html / cam_viz.png")

    # the gaze overlay on a seeded clip (the array half: no libav on this machine)
    t0 = time.perf_counter()
    clip = rng.integers(0, 256, HOST_CLIP, dtype=np.uint8)
    gaze = np.load(files["gaze"])
    drawn = vis_gaze.overlay_gaze(clip, gaze)
    seconds["overlay_gaze"] = time.perf_counter() - t0
    idx = np.linspace(0, len(gaze) - 1, len(clip)).round().astype(int)
    h, w = HOST_CLIP[1:3]
    yy, xx = np.mgrid[:h, :w]
    for t in range(len(clip)):
        g = gaze[idx[t]]
        disc = np.zeros((h, w), bool)
        if not np.isnan(g).any():
            x, y = int(np.clip(g[0], 0, 1) * (w - 1)), int(np.clip(g[1], 0, 1) * (h - 1))
            disc = (yy - y) ** 2 + (xx - x) ** 2 <= 16
        if not (drawn[t][disc] == (255, 32, 32)).all() or \
                not np.array_equal(drawn[t][~disc], clip[t][~disc]):
            raise AssertionError(f"overlay_gaze: frame {t} is not the clip with a radius-4 disc")
    print(f"overlay_gaze: {len(clip)} frames of {HOST_CLIP[1]}^2, each the clip with one "
          f"radius-4 disc at its resampled gaze point")

    # the tokenizer examples on the eval phase's .pth files, on the card and the CPU
    tokenize_file = run_training_vqvae.tokenize_file
    legs = []

    def timed(args, tok, path):
        if args.device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tokenize_file(args, tok, path)
        if args.device == "cuda":
            torch.cuda.synchronize()
        legs.append((time.perf_counter() - t0) * 1e3)
        return res

    run_training_vqvae.tokenize_file = timed
    try:
        for domain, example, data in (("cam", tok_cam_example, poses),
                                      ("gaze", tok_gaze_example, gaze_px)):
            res = {}
            for device in ("cuda", "cpu"):
                legs.clear()
                t0 = time.perf_counter()
                metrics = example.main(["--ckpt", files[f"{domain}_ckpt"], f"--{domain}", data,
                                        "--out", os.path.join(root, device), "--device", device])
                total = time.perf_counter() - t0
                tok = os.path.join(root, device, "token", f"{domain}-")
                res[device] = (np.load(tok + "tok.npz")["arr_0"], np.load(tok + "recon.npy"))
                seconds[f"tok_{domain}_example_{device}"] = total
                print(f"tok_{domain}_example --device {device}: tokenize {legs[0]:.1f} ms, "
                      f"reconstruct {legs[1]:.1f} ms, {total:.2f} s with the loads; {metrics}")
            (tc, rc), (tp, rp) = res["cuda"], res["cpu"]
            err = float(np.abs(rc - rp).max())
            if tc.shape != (30,) or not 0 <= tc.min() <= tc.max() < 256 or \
                    not np.array_equal(tc, tp) or not np.isfinite(rc).all() or \
                    rc.shape != (60, 9 if domain == "cam" else 2) or err > HOST_TOOLS_ATOL:
                raise AssertionError(f"tok_{domain}_example: tokens {tc.shape} equal to the "
                                     f"CPU's {np.array_equal(tc, tp)}, reconstruction "
                                     f"{rc.shape} against the CPU's {err:.3e}")
            print(f"tok_{domain}_example: the card's 30 tokens equal the CPU's, its "
                  f"reconstruction within {err:.3e} of the CPU's (tolerance {HOST_TOOLS_ATOL:g})")
    finally:
        run_training_vqvae.tokenize_file = tokenize_file

    launches = {"flash64": flash64_attention.launches, **_counts()}
    if any(launches.values()):
        raise AssertionError(f"the host tools launched kernels: {launches}")
    print("host tools: " + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
          + "; 0 kernel launches")
    print(f"host tools phase: {time.perf_counter() - t_phase:.1f} s")


def _train_case(rng, dev, name, n, mode, C=HEADS * 64):
    """q/k/v (and do) as the step hands them to the kernels: self-attention
    views of one (B, N, 3C) qkv projection; the mask of `mode`."""
    qkv, do = _randn(rng, (B, n, 3 * C), dev), _randn(rng, (B, n, C), dev)
    kvb = seg = None
    if mode == "kp":  # each row's tail blocked, one row fully open
        live = torch.from_numpy(rng.integers(n // 2, n, B)).to(dev)
        live[0] = n
        kvb = torch.arange(n, device=dev)[None] >= live[:, None]
    elif mode == "seg":  # four modality blocks, then the masked positions
        ids = torch.tensor([31433, 17061, 7210, 25377, -1], device=dev, dtype=torch.int32)
        block = torch.from_numpy(np.sort(rng.integers(0, 5, (B, n)), axis=1)).to(dev)
        seg = ids[block]
    return name, qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], do, kvb, seg


def train_kernel_phase(dev):
    import egom2p_torch.ops.flash64_train as ft

    rng = np.random.default_rng(1)
    cases = [_train_case(rng, dev, "encoder self-attention, 2048^2, key padding", 2048, "kp"),
             _train_case(rng, dev, "decoder self-attention, 2048^2, segments", 2048, "seg"),
             _train_case(rng, dev, "self-attention, 2048^2, no mask", 2048, "none"),
             _train_case(rng, dev, "ragged 2000^2, segments", 2000, "seg")]
    rows = []
    for name, q, k, v, do, kvb, seg in cases:
        lib_fwd, lib_bwd, picked = _sdpa_ms(*(_split_heads(t, HEADS) for t in (q, k, v)),
                                            kvb, seg, backward=True, kernel_name=not rows)
        print(f"flash64_train {name}: scaled_dot_product_attention forward {lib_fwd:.3f} ms, "
              f"backward {lib_bwd:.3f} ms{picked}")
        for safemax in (False, True):
            mode = "safemax" if safemax else "clamp"
            o, l2 = ft.flash64_train_fwd(q, k, v, kvb, seg, safemax)
            torch.cuda.synchronize()
            ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, kvb, seg, safemax)
            d = ft.row_dot(do, ro)
            dq = ft.flash64_train_dq(q, k, v, do, rl2, d, kvb, seg, safemax)
            dk, dv = ft.flash64_train_dkv(q, k, v, do, rl2, d, kvb, seg, safemax)
            torch.cuda.synchronize()
            rdq, rdk, rdv = ft.flash64_train_reference_bwd(q, k, v, ro, rl2, do, kvb, seg, safemax)
            err = {"o": (o.float() - ro.float()).abs().max().item(),
                   "L2": (l2 - rl2).abs().max().item()}
            for g_name, g, r in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
                err[g_name] = (g.float() - r.float()).abs().max().item()
                if err[g_name] > TRAIN_GRAD_TOL * r.float().abs().max().item():
                    raise AssertionError(f"{name} {mode}: {g_name} error {err[g_name]}")
            if err["o"] > TRAIN_O_ATOL or err["L2"] > TRAIN_L2_ATOL:
                raise AssertionError(f"{name} {mode}: o / L2 errors {err}")
            if kvb is not None:
                dead = kvb.all(dim=1)
                if dead.any() and not ((o[dead] == 0).all() and (dq[dead] == 0).all()):
                    raise AssertionError(f"{name}: fully blocked rows are not exact zeros")
            args = (q, k, v, do, rl2, d, kvb, seg, safemax)
            ms = {"fwd": _cuda_time_ms(lambda: ft.flash64_train_fwd(q, k, v, kvb, seg, safemax), 10),
                  "dq": _cuda_time_ms(lambda: ft.flash64_train_dq(*args), 10),
                  "dkv": _cuda_time_ms(lambda: ft.flash64_train_dkv(*args), 10)}
            plain = {"fwd": _cuda_time_ms(
                         lambda: ft.flash64_train_reference_fwd(q, k, v, kvb, seg, safemax), 2, 1),
                     "dq": _cuda_time_ms(lambda: ft.flash64_train_reference_dq(*args), 2, 1),
                     "dkv": _cuda_time_ms(lambda: ft.flash64_train_reference_dkv(*args), 2, 1)}
            print(f"flash64_train {mode:7s} {name}: max_abs_err "
                  + " ".join(f"{k} {v:.2e}" for k, v in err.items())
                  + "  kernel ms " + " ".join(f"{k} {v:.3f}" for k, v in ms.items())
                  + "  plain ms " + " ".join(f"{k} {v:.3f}" for k, v in plain.items()))
            rows.append({"case": name, "mode": mode, "err": err, "ms": ms, "plain_ms": plain,
                         "library_ms": {"fwd": lib_fwd, "bwd": lib_bwd}})
        del q, k, v, do
    return rows


def _step_live_rows(R, dev, gen):
    """The rows of one 64k head in a training step: each 2048-row sample
    holds one contiguous run of 1024 of them at a random start, as the
    decoder's modality blocks lay them out (about half the rows)."""
    start = torch.randint(0, 1024, (R // 2048 + 1,), device=dev, generator=gen)
    pos = torch.arange(R, device=dev)
    return ((pos % 2048) >= start[pos // 2048]) & ((pos % 2048) < start[pos // 2048] + 1024)


# flash-CE forward cases (R, V, D, live rows): the base step's head with all
# rows and with half the rows live, vocabs its tiles do not divide (the
# caption head's 30000 among them), the
# wider registry dims, and the split instance at the trainer's B = 1 (R =
# 2048) and the dim-1024 check step's R = 512
CE_FWD_CASES = ((16384, 64000, 768, "all"), (1000, 64007, 768, "all"),
                (16384, 30000, 768, "all"),
                (16384, 64000, 1024, "all"), (16384, 64000, 2048, "all"),
                (16384, 64000, 768, "step"), (2048, 64000, 768, "all"),
                (512, 64000, 768, "all"), (2048, 64000, 1024, "all"),
                (512, 64000, 1024, "all"))


def ce_phase(dev):
    """The CE forward kernel against its plain version (CE_FWD_CASES): live
    rows within CE_LOGZ_RTOL / CE_GOLD_ATOL, dead rows exactly +inf / 0; two
    runs of the split instance bitwise equal; beside cuBLAS's bf16 y @ W^T
    alone at the full-R shapes (a product that writes the R x V logits, not
    the same function)."""
    from egom2p_torch.ops.flash_ce import fwd_plan, fwd_splits, row_stats, row_stats_reference

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for R, V, D, which in CE_FWD_CASES:
        gen = torch.Generator(device=dev).manual_seed(R + D)
        y = torch.randn((R, D), device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn((V, D), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        t = torch.randint(0, V, (R,), device=dev, generator=gen, dtype=torch.int32)
        t[-1] = V - 1  # a target in the last real column
        live = None if which == "all" else _step_live_rows(R, dev, gen)
        logz, gold = row_stats(y, w, t, live=live)
        torch.cuda.synchronize()
        rlogz, rgold = row_stats_reference(y, w, t, live=live)
        on = torch.ones(R, dtype=torch.bool, device=dev) if live is None else live
        err = max((logz[on] - rlogz[on]).abs().max().item(),
                  (gold[on] - rgold[on]).abs().max().item())
        torch.testing.assert_close(logz[on], rlogz[on], rtol=CE_LOGZ_RTOL, atol=0)
        torch.testing.assert_close(gold[on], rgold[on], rtol=0, atol=CE_GOLD_ATOL)
        if not (torch.all(logz[~on] == math.inf) and torch.all(gold[~on] == 0)):
            raise AssertionError(f"flash_ce_fwd R={R} D={D}: a dead row is not +inf / 0")
        splits = fwd_splits(R, D, V, n_sm)
        if splits > 1:  # the combine pass folds the slices in a fixed order
            again = row_stats(y, w, t, live=live)
            if not (torch.equal(again[0], logz) and torch.equal(again[1], gold)):
                raise AssertionError(f"flash_ce_fwd R={R} D={D}: two runs differ")
        ms = _cuda_time_ms(lambda: row_stats(y, w, t, live=live), 5)
        plain_ms = _cuda_time_ms(lambda: row_stats_reference(y, w, t, live=live), 3, 1)
        matmul_ms = None
        if R == 16384 and which == "all":
            matmul_ms = _cuda_time_ms(lambda: torch.matmul(y, w.t()), 5)
        n_live = int(on.sum().item())
        tflops = 2.0 * n_live * D * V / ms / 1e9
        bound = ce_fwd_bound_ms(n_live, D, V)[0]
        print(f"flash_ce_fwd R={R} D={D} V={V}, {n_live} rows live (y {fwd_plan(D)}, S={splits}"
              f"{', two runs bitwise equal' if splits > 1 else ''}): max_abs_err {err:.3e}  "
              f"kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s over the live rows; bound {bound:.3f} "
              f"ms, {bound / ms:.0%})  plain {plain_ms:.3f} ms"
              + (f"  cuBLAS y @ W^T alone {matmul_ms:.3f} ms" if matmul_ms else ""))
        rows.append({"R": R, "V": V, "D": D, "live_rows": n_live, "err": err, "ms": ms,
                     "plain_ms": plain_ms, "matmul_ms": matmul_ms, "splits": splits})
        del y, w
    return rows


def fused_bwd_phase(dev):
    """The fused dq/dk/dv kernel against its plain version, timed beside
    the split dq + dk/dv kernels, at the training step's shapes."""
    import egom2p_torch.ops.flash64_train as ft

    rng = np.random.default_rng(2)
    cases = [_train_case(rng, dev, "encoder self-attention, 2048^2, key padding", 2048, "kp"),
             _train_case(rng, dev, "decoder self-attention, 2048^2, segments", 2048, "seg"),
             _train_case(rng, dev, "ragged 2000^2, segments", 2000, "seg")]
    rows = []
    for name, q, k, v, do, kvb, seg in cases:
        for safemax in (False, True):
            mode = "safemax" if safemax else "clamp"
            ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, kvb, seg, safemax)
            args = (q, k, v, do, rl2, ft.row_dot(do, ro), kvb, seg, safemax)
            got = ft.flash64_train_dqkv(*args)
            torch.cuda.synchronize()
            ref = ft.flash64_train_reference_dqkv(*args)
            err = {}
            for g_name, g, r in zip(("dq", "dk", "dv"), got, ref):
                err[g_name] = (g.float() - r.float()).abs().max().item()
                if err[g_name] > TRAIN_GRAD_TOL * r.float().abs().max().item():
                    raise AssertionError(f"fused {name} {mode}: {g_name} error {err[g_name]}")
            for _ in range(2):  # dq's atomic adds change order; dk and dv may not move
                _, dk2, dv2 = ft.flash64_train_dqkv(*args)
                if not (torch.equal(dk2, got[1]) and torch.equal(dv2, got[2])):
                    raise AssertionError(f"fused {name} {mode}: dk or dv differ between runs")
            ms = _cuda_time_ms(lambda: ft.flash64_train_dqkv(*args), 10)
            split_ms = _cuda_time_ms(lambda: (ft.flash64_train_dq(*args),
                                              ft.flash64_train_dkv(*args)), 10)
            plain_ms = _cuda_time_ms(lambda: ft.flash64_train_reference_dqkv(*args), 2, 1)
            print(f"flash64_train_dqkv {mode:7s} {name}: max_abs_err "
                  + " ".join(f"{k} {v:.2e}" for k, v in err.items())
                  + f"  fused {ms:.3f} ms  split dq+dkv {split_ms:.3f} ms  plain {plain_ms:.3f} ms")
            rows.append({"case": name, "mode": mode, "err": max(err.values()), "ms": ms,
                         "split_ms": split_ms, "plain_ms": plain_ms})
        del q, k, v, do
    return rows


def ragged_bwd_phase(dev):
    """The dq, dk/dv and fused kernels against their plain versions at
    lengths around their 128-row blocks and 64-row streamed tiles:
    self-attention views of one qkv projection with no mask, key padding
    (batch row 1 fully blocked: every gradient there is exact zeros) and
    segments with -1; N != M with no mask and key padding.  Both softmax
    forms.  Returns the number of cases."""
    import egom2p_torch.ops.flash64_train as ft

    b, heads = 2, 2
    C = heads * 64
    rng = np.random.default_rng(5)
    randn = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape, np.float32)).to(dev, torch.bfloat16)
    ids = np.array([31433, 17061, 7210, -1], np.int32)
    cases = []
    for n in RAGGED_SELF:
        qkv = randn(b, n, 3 * C)
        kvb = torch.from_numpy(rng.uniform(size=(b, n)) < 0.3)
        kvb[1] = True
        seg = torch.from_numpy(ids[np.sort(rng.integers(0, 4, (b, n)), axis=1)]).to(dev)
        for mode, mk, sg in (("none", None, None), ("kp", kvb.to(dev), None), ("seg", None, seg)):
            cases.append((f"{n}^2 {mode}", qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:],
                          randn(b, n, C), mk, sg))
    for n_q, n_kv in RAGGED_CROSS:
        q, kv = randn(b, n_q, 3 * C)[..., :C], randn(b, n_kv, 2 * C)
        kvb = torch.from_numpy(rng.uniform(size=(b, n_kv)) < 0.3)
        kvb[1] = True
        for mode, mk in (("none", None), ("kp", kvb.to(dev))):
            cases.append((f"{n_q}x{n_kv} {mode}", q, kv[..., :C], kv[..., C:], randn(b, n_q, C),
                          mk, None))
    n_cases, worst = 0, 0.0
    for name, q, k, v, do, mk, sg in cases:
        for safemax in (False, True):
            ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, mk, sg, safemax)
            args = (q, k, v, do, rl2, ft.row_dot(do, ro), mk, sg, safemax)
            dq = ft.flash64_train_dq(*args)
            dk, dv = ft.flash64_train_dkv(*args)
            fused = ft.flash64_train_dqkv(*args)
            torch.cuda.synchronize()
            ref = ft.flash64_train_reference_dqkv(*args)
            for g_name, g, r in zip(("dq", "dk", "dv", "fused dq", "fused dk", "fused dv"),
                                    (dq, dk, dv) + tuple(fused), ref + ref):
                scale = r.float().abs().max().item()
                err = (g.float() - r.float()).abs().max().item()
                if not torch.isfinite(g).all() or err > TRAIN_GRAD_TOL * scale + RAGGED_GRAD_ATOL:
                    raise AssertionError(f"ragged backward {name} safemax={safemax}: {g_name} "
                                         f"error {err} against max |ref| {scale}")
                if mk is not None and not (g[1] == 0).all():
                    raise AssertionError(f"ragged backward {name}: {g_name} of a fully blocked "
                                         f"batch row is not exact zeros")
                worst = max(worst, err / (TRAIN_GRAD_TOL * scale + RAGGED_GRAD_ATOL))
            n_cases += 1
    print(f"flash64_train backward (dq, dk/dv, fused), ragged lengths {RAGGED_SELF} and "
          f"{RAGGED_CROSS}: {n_cases} cases, largest error {worst:.3f} of its tolerance "
          f"({TRAIN_GRAD_TOL} of the gradient's max + {RAGGED_GRAD_ATOL})")
    return n_cases


def ce_bwd_phase(dev):
    """The CE backward kernel against the plain chunked backward (the
    default), with about half the rows at weight 0 at the step's shape, and
    at the other column plans: D = 128, 384, 640 (a 128-column warpgroup),
    1024 and 2048 (column groups over a streamed owned tile)."""
    from egom2p_torch.ops.flash_ce import (_bwd_chunked, bwd_column_plan, ce_bwd,
                                           row_stats_reference)

    rows = []
    for R, V, D in ((16384, 64000, 768), (1000, 64007, 768), (16384, 64000, 128),
                    (16384, 64000, 384), (16384, 64000, 640), (16384, 64000, 1024),
                    (16384, 64000, 2048)):
        gen = torch.Generator(device=dev).manual_seed(R + 1)
        y = torch.randn((R, D), device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn((V, D), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        t = torch.randint(0, V, (R,), device=dev, generator=gen, dtype=torch.int32)
        live = _step_live_rows(R, dev, gen)  # the weight is 1 / count
        wc = live.float() / live.sum().clamp(min=1)
        logz, _ = row_stats_reference(y, w, t)
        dy, dw = ce_bwd(y, w, t, wc, logz)
        torch.cuda.synchronize()
        rdy, rdw = _bwd_chunked(y, w, t, wc, logz, 2048, dy_f32=True)
        err = {"dy": (dy - rdy).abs().max().item(), "dW": (dw - rdw).abs().max().item()}
        if (err["dy"] > CE_BWD_TOL * rdy.abs().max().item()
                or err["dW"] > CE_BWD_TOL * rdw.abs().max().item()):
            raise AssertionError(f"CE backward R={R} V={V}: errors {err}")
        if torch.count_nonzero(dy[~live]) != 0:
            raise AssertionError("CE backward: rows of weight 0 have a nonzero dy")
        ms = _cuda_time_ms(lambda: ce_bwd(y, w, t, wc, logz), 3, 1)
        plain_ms = _cuda_time_ms(lambda: _bwd_chunked(y, w, t, wc, logz, 2048), 3, 1)
        n_live = int(live.sum().item())
        print(f"flash_ce_bwd R={R} D={D} V={V} (column plan {bwd_column_plan(D)}, "
              f"{live.float().mean().item():.0%} rows live): max_abs_err dy {err['dy']:.2e} "
              f"dW {err['dW']:.2e}  kernel {ms:.3f} ms (bound "
              f"{ce_bwd_bound_ms(n_live, R, D, V)[0]:.3f} ms)  plain chunked {plain_ms:.3f} ms")
        rows.append({"R": R, "V": V, "D": D, "err": max(err.values()), "ms": ms,
                     "plain_ms": plain_ms, "live_rows": n_live})
        del y, w, dy, dw, rdy, rdw
    return rows


def _stock_case(rng, dev, n, heads, hd, mode, dead_row=False):
    """Head-major q/k/v (and do) as views of one (B, N, 3C) qkv projection
    split into heads, the layout the model hands the stock route."""
    C = heads * hd
    qkv = _randn(rng, (B, n, 3 * C), dev)
    split = lambda t: t.unflatten(-1, (heads, hd)).transpose(1, 2)  # noqa: E731
    do = _randn(rng, (B, heads, n, hd), dev)
    kvb = seg = None
    if mode == "kp":
        live = torch.from_numpy(rng.integers(n // 2, n, B)).to(dev)
        if dead_row:
            live[-1] = 0
        kvb = torch.arange(n, device=dev)[None] >= live[:, None]
    else:
        ids = torch.tensor([31433, 17061, 7210, 25377, -1], device=dev, dtype=torch.int32)
        seg = ids[torch.from_numpy(np.sort(rng.integers(0, 5, (B, n)), axis=1)).to(dev)]
    return (split(qkv[..., :C]), split(qkv[..., C:2 * C]), split(qkv[..., 2 * C:]), do,
            kvb, seg)


def stock_kernel_phase(dev):
    """The stock route's forward and fused backward kernels against their
    plain versions, at EgoM2P-large's heads (68, run at 80) and at 64."""
    import egom2p_torch.ops.flash64_train as ft
    import egom2p_torch.ops.flash_attention as fa

    rng = np.random.default_rng(3)
    rows = []
    for heads, hd in ((LARGE_HEADS, LARGE_HD), (HEADS, 64)):
        for mode, dead in (("kp", True), ("seg", False)):
            q, k, v, do, kvb, seg = _stock_case(rng, dev, 2048, heads, hd, mode, dead)
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            route = fa.segment_flash_attention if seg is not None else fa.padding_flash_attention
            out = route(qr, kr, vr, seg if seg is not None else kvb)
            out.backward(do)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q, k, v, kvb, seg)
            err = {"o": (out.float() - ref.float()).abs().max().item()}
            if err["o"] > TRAIN_O_ATOL:
                raise AssertionError(f"stock route hd {hd} {mode}: o error {err['o']}")
            for g_name, g, r in zip(("dq", "dk", "dv"), (qr.grad, kr.grad, vr.grad),
                                    fa.flash_attention_reference_bwd(q, k, v, do, kvb, seg)):
                err[g_name] = (g.float() - r.float()).abs().max().item()
                if err[g_name] > TRAIN_GRAD_TOL * r.float().abs().max().item():
                    raise AssertionError(f"stock route hd {hd} {mode}: {g_name} error "
                                         f"{err[g_name]}")
            if kvb is not None:
                dead_b = kvb.all(dim=1)
                if not dead_b.any() or not all(bool((t[dead_b] == 0).all())
                                               for t in (out, qr.grad, kr.grad, vr.grad)):
                    raise AssertionError("stock route: a fully blocked row is not exact zeros")
            # the kernels alone, on the packed operands the route hands them
            hdk = fa.kernel_head_dim(hd)
            qp, kp, vp, dop = (fa._pack(t, hdk) for t in (q, k, v, do))
            kw = dict(hd=hdk, sm_scale=hd ** -0.5)
            o, l2 = fa.flash_attention_fwd(qp, kp, vp, kvb, seg, **kw)
            bargs = (qp, kp, vp, dop, l2, ft.row_dot(dop, o, hdk), kvb, seg)
            ms = {"fwd": _cuda_time_ms(lambda: fa.flash_attention_fwd(qp, kp, vp, kvb, seg, **kw), 10),
                  "bwd": _cuda_time_ms(lambda: fa.flash_attention_bwd(*bargs, **kw), 10)}
            plain = {"fwd": _cuda_time_ms(lambda: ft.flash64_train_reference_fwd(
                         qp, kp, vp, kvb, seg, True, **kw), 2, 1),
                     "bwd": _cuda_time_ms(lambda: ft.flash64_train_reference_dqkv(
                         *bargs, True, **kw), 2, 1)}
            lib_fwd, lib_bwd, picked = _sdpa_ms(q, k, v, kvb, seg, backward=True, reps=3,
                                                kernel_name=not rows)
            name = f"hd {hd} (kernel {hdk}), {heads} heads, 2048^2, {mode}"
            print(f"stock route {name}: scaled_dot_product_attention forward {lib_fwd:.3f} ms, "
                  f"backward {lib_bwd:.3f} ms{picked}")
            library = {"fwd": lib_fwd, "bwd": lib_bwd}
            if hdk != hd:
                # the same call on the heads zero-padded to the kernel's width
                # with the true head's scale, which cuDNN's kernels can take
                padded = [torch.nn.functional.pad(t, (0, hdk - hd)) for t in (q, k, v)]
                pad_fwd, pad_bwd, pad_picked = _sdpa_ms(*padded, kvb, seg, backward=True, reps=3,
                                                        scale=hd ** -0.5, kernel_name=not rows)
                print(f"stock route {name}: scaled_dot_product_attention on heads padded to "
                      f"{hdk}: forward {pad_fwd:.3f} ms, backward {pad_bwd:.3f} ms{pad_picked}")
                library = {"fwd": pad_fwd, "bwd": pad_bwd, "math_fwd": lib_fwd,
                           "math_bwd": lib_bwd}
                del padded
            print(f"stock route {name}: max_abs_err "
                  + " ".join(f"{k} {v:.2e}" for k, v in err.items())
                  + "  kernel ms " + " ".join(f"{k} {v:.3f}" for k, v in ms.items())
                  + "  plain ms " + " ".join(f"{k} {v:.3f}" for k, v in plain.items()))
            rows.append({"case": name, "hd": hd, "err": err, "ms": ms, "plain_ms": plain,
                         "library_ms": library})
            del q, k, v, do, qr, kr, vr, qp, kp, vp, dop
    wide_ragged(dev)
    # the forward at a serving length (EgoM2P-large's encoder at 8704 tokens)
    q, k, v, _, kvb, _ = _stock_case(rng, dev, 8704, LARGE_HEADS, LARGE_HD, "kp")
    with torch.no_grad():
        out = fa.padding_flash_attention(q, k, v, kvb)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v, kvb)
        err = (out.float() - ref.float()).abs().max().item()
        if err > TRAIN_O_ATOL:
            raise AssertionError(f"stock route forward at 8704^2: error {err}")
        ms = _cuda_time_ms(lambda: fa.padding_flash_attention(q, k, v, kvb), 5)
        plain_ms = _cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v, kvb), 2, 1)
    print(f"stock route forward hd {LARGE_HD}, {LARGE_HEADS} heads, 8704^2, kp: max_abs_err "
          f"{err:.2e}  route (pack + kernel) {ms:.3f} ms  plain {plain_ms:.3f} ms")
    return rows


def wide_ragged(dev):
    """The width-80 forward and fused backward kernels against their plain
    versions at lengths on both sides of their tiles (128-row query tiles
    and 128-key stages; 128-key blocks, 32-row query steps and 64-query dQ
    tiles): heads of 68 packed to 80, self-attention with no mask, key
    padding (batch row 1 fully blocked: exact zeros, L2 = 1e30) and segments
    with -1, and N != M."""
    import egom2p_torch.ops.flash64_train as ft
    import egom2p_torch.ops.flash_attention as fa

    b, heads, hd = 2, 3, 68
    rng = np.random.default_rng(8)
    kw = dict(hd=80, sm_scale=hd ** -0.5)
    ids = np.array([31433, 17061, 7210, -1], np.int32)
    cases = [(n, n, mode) for n in (1, 31, 33, 64, 65, 127, 129, 161, 300)
             for mode in ("none", "kp", "seg")] + [(33, 200, "kp"), (200, 33, "kp"), (129, 1, "kp")]
    worst = 0.0
    for n_q, n_kv, mode in cases:
        q, k, v, do = (fa._pack(torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, torch.bfloat16), 80) for shape in ((b, heads, n_q, hd), (b, heads, n_kv, hd),
                                                   (b, heads, n_kv, hd), (b, heads, n_q, hd)))
        kvb = seg = None
        if mode == "kp":
            kvb = torch.from_numpy(rng.uniform(size=(b, n_kv)) < 0.3).to(dev)
            kvb[1] = True
        elif mode == "seg":
            seg = torch.from_numpy(ids[np.sort(rng.integers(0, 4, (b, n_q)), axis=1)]).to(dev)
        o, l2 = fa.flash_attention_fwd(q, k, v, kvb, seg, **kw)
        torch.cuda.synchronize()
        ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, kvb, seg, True, **kw)
        if (o.float() - ro.float()).abs().max() > TRAIN_O_ATOL or (l2 - rl2).abs().max() > TRAIN_L2_ATOL:
            raise AssertionError(f"width-80 forward {n_q}x{n_kv} {mode}: o or L2 disagree")
        args = (q, k, v, do, rl2, ft.row_dot(do, ro, 80), kvb, seg)
        got = fa.flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
        for g_name, g, r in zip(("dq", "dk", "dv"), got,
                                ft.flash64_train_reference_dqkv(*args, True, **kw)):
            scale = r.float().abs().max().item()
            err = (g.float() - r.float()).abs().max().item()
            if not torch.isfinite(g).all() or err > TRAIN_GRAD_TOL * scale + RAGGED_GRAD_ATOL:
                raise AssertionError(f"width-80 backward {n_q}x{n_kv} {mode}: {g_name} error {err}")
            worst = max(worst, err / (TRAIN_GRAD_TOL * scale + RAGGED_GRAD_ATOL))
        if kvb is not None and not ((o[1] == 0).all() and (l2[1] == 1e30).all()
                                    and all(bool((g[1] == 0).all()) for g in got)):
            raise AssertionError(f"width-80 {n_q}x{n_kv}: a fully blocked batch row is not zeros")
    print(f"width-80 forward and fused backward, ragged lengths: {len(cases)} cases, largest "
          f"gradient error {worst:.3f} of its tolerance, dead rows exact zeros")


def train_flops_per_sample(n_in=2048, n_tgt=2048, n_layers=12, dim=768, h=2048,
                           vocab=64000):
    """Model FLOPs of one training sample, bench_train.py:32-47's formula:
    forward matmuls (encoder at n_in, decoder self at n_tgt and cross to
    n_in, the CE head at the 64k vocab for every target) times 3."""
    enc = n_layers * (8 * n_in * dim ** 2 + 4 * n_in ** 2 * dim + 6 * n_in * dim * h)
    dec = n_layers * (8 * n_tgt * dim ** 2 + 4 * n_tgt ** 2 * dim + 4 * n_tgt * n_in * dim
                      + 4 * n_tgt * dim ** 2 + 4 * n_in * dim ** 2 + 6 * n_tgt * dim * h)
    return 3 * (enc + dec + 2 * n_tgt * dim * vocab)


def _wrappers():
    """Every kernel wrapper of the training paths, by short name; each
    counts its CUDA launches in `.launches`."""
    import egom2p_torch.ops.flash64_train as ft
    import egom2p_torch.ops.flash_attention as fa
    import egom2p_torch.ops.flash_ce as fce
    return {"fwd": ft.flash64_train_fwd, "dq": ft.flash64_train_dq,
            "dkv": ft.flash64_train_dkv, "dqkv": ft.flash64_train_dqkv,
            "ce_fwd": fce.row_stats, "ce_bwd": fce.ce_bwd,
            "stock_fwd": fa.flash_attention_fwd, "stock_bwd": fa.flash_attention_bwd}


def _counts():
    return {k: f.launches for k, f in _wrappers().items()}


def _reset_counts():
    for f in _wrappers().values():
        f.launches = 0


def _kernel_class(name: str) -> str:
    # template arguments: flash64_fwd_kernel<HD, SAFEMAX, SEG, L2>,
    # flash64_dkv_kernel<HD, CLAMP, SEG, FUSED>
    if "flash64_fwd_kernel<80" in name:
        return "stock route fwd (hd 80)"
    if "flash64_dkv_kernel<80" in name:
        return "stock route fused bwd (hd 80)"
    if "flash64_fwd_kernel" in name:
        return "flash64 fwd"
    if "flash64_dkv_kernel" in name:
        return "flash64_train dq/dk/dv (fused)" if ", true>" in name else "flash64_train dk/dv"
    for key, cls in (("flash64_dq_kernel", "flash64_train dq"),
                     ("flash_ce_fwd_kernel", "flash-CE fwd"),
                     ("flash_ce_bwd_kernel", "flash-CE bwd")):
        if key in name:
            return cls
    low = name.lower()
    if any(k in low for k in ("gemm", "sm90_xmma", "cutlass", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "multi_tensor" in low or "adam" in low:
        return "optimizer"
    if "reduce" in low or "norm" in low or "softmax" in low:
        return "reductions"
    if "elementwise" in low or "vectorized" in low or "copy" in low or "fill" in low:
        return "elementwise / copies"
    return "other"


def profile_step(model, optimizer, batch, step_ms):
    """One training step under torch.profiler: device time by kernel class,
    and the device's idle share against the unprofiled step time `step_ms`
    (the profiler's own host overhead stretches the traced step)."""
    from torch.profiler import ProfilerActivity, profile

    from egom2p_torch.train.egom2p_train import make_train_step

    step_fn = make_train_step(model, optimizer, 2048, 2048, "mod")
    gen = torch.Generator().manual_seed(7)
    step_fn(batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _device_breakdown(prof, "step", wall_ms, step_ms)


def _device_breakdown(prof, what, wall_ms, ref_ms, top=0):
    """Prints a trace's device time by kernel class and the device's idle
    share against `ref_ms`, the same work's time without the profiler (and
    the `top` longest kernels by name)."""
    spans, by_class, by_name = [], {}, {}
    for e in prof.events():
        # kernels and copies only: the optimizer's annotated ranges
        # ("Optimizer.step#AdamW.step") also sit on the device timeline
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False) or e.name.startswith("Optimizer.")):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        cls = _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + (end - start) / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) / 1e3
    if not spans:  # a measurement, not a check: say so and go on
        print(f"profiled {what}: wall {wall_ms:.1f} ms; the profiler recorded no device "
              f"activity, device time by kernel class not measured")
        return
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    window_ms = (spans[-1][1] - spans[0][0]) / 1e3
    total = sum(by_class.values())
    print(f"profiled {what}: wall {wall_ms:.1f} ms, device window {window_ms:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms; idle share {1 - busy / 1e3 / ref_ms:.3f} of "
          f"the unprofiled {ref_ms:.1f} ms {what} ({1 - busy / 1e3 / window_ms:.3f} of the "
          f"traced window)")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:24s} {ms:9.2f} ms  {ms / total:6.1%}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:9.2f} ms  {name[:110]}")


def _plain_stock_fwd(q, k, v, kv_blocked=None, segments=None, *, hd, sm_scale):
    import egom2p_torch.ops.flash64_train as ft
    return ft.flash64_train_reference_fwd(q, k, v, kv_blocked, segments, True, hd=hd,
                                          sm_scale=sm_scale)


def _plain_stock_bwd(q, k, v, do, l2, d, kv_blocked=None, segments=None, *, hd, sm_scale):
    import egom2p_torch.ops.flash64_train as ft
    return ft.flash64_train_reference_dqkv(q, k, v, do, l2, d, kv_blocked, segments, True,
                                           hd=hd, sm_scale=sm_scale)


def _plain_versions(kind: str):
    """[(module, wrapper name, plain version)] of the kernels a run uses."""
    import egom2p_torch.ops.flash64_train as ft
    import egom2p_torch.ops.flash_attention as fa
    import egom2p_torch.ops.flash_ce as fce
    if kind == "large":
        return [(fa, "flash_attention_fwd", _plain_stock_fwd),
                (fa, "flash_attention_bwd", _plain_stock_bwd)]
    swaps = [(ft, "flash64_train_fwd", ft.flash64_train_reference_fwd),
             (fce, "row_stats", fce.row_stats_reference)]
    if kind == "wide_ce":
        return swaps + [(ft, "flash64_train_dq", ft.flash64_train_reference_dq),
                        (ft, "flash64_train_dkv", ft.flash64_train_reference_dkv),
                        (fce, "ce_bwd", fce.ce_bwd_reference)]
    if kind == "fused":
        return swaps + [(ft, "flash64_train_dqkv", ft.flash64_train_reference_dqkv),
                        (fce, "ce_bwd", fce.ce_bwd_reference)]
    return swaps + [(ft, "flash64_train_dq", ft.flash64_train_reference_dq),
                    (ft, "flash64_train_dkv", ft.flash64_train_reference_dkv)]


@contextlib.contextmanager
def _swapped(swaps):
    """The wrappers in `swaps` replaced by their plain versions."""
    kernels = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), kernel in zip(swaps, kernels):
            setattr(mod, name, kernel)


def step_check(model, batch, expected, swaps, n_tokens=2048):
    """Loss and gradients of one step on `batch` (n_tokens input and target
    tokens), kernels vs plain versions (the wrappers in `swaps` replaced by
    their plain versions).  The gradients are those of the training loss (a
    mean of the modalities' mean CE); the loss is compared as the mean CE
    per target token, the modalities' means weighted by their target counts
    in the batch.  The mean of means is noisy where a modality holds few
    targets: with unchanged kernels it moved by 7e-6 to 1.35e-4 between runs
    on EgoM2P-large's batch of 4 (single samples: up to 1.0e-3), the bf16
    noise of one attention route against the other over a few cam or gaze
    tokens (NVIDIA H100 80GB HBM3, 700 W)."""
    counts = {m: float((~d["target_mask"].bool()).sum()) for m, d in batch.items()}

    def run():
        model.zero_grad(set_to_none=True)
        loss, mod_loss = model(batch, n_tokens, n_tokens, "mod")
        loss.backward()
        per_token = sum(v.item() * counts[m] for m, v in mod_loss.items()) / sum(
            counts[m] for m in mod_loss)
        return loss.item(), per_token, [p.grad.float().clone() for p in model.parameters()]

    before = _counts()
    loss_k, tok_k, grads_k = run()
    after = _counts()
    if {k: after[k] - before[k] for k in after} != expected:
        raise AssertionError("the kernel run of the step check missed a kernel")
    with _swapped(swaps):
        loss_p, tok_p, grads_p = run()
    num = math.sqrt(sum(((a - b) ** 2).sum().item() for a, b in zip(grads_k, grads_p)))
    den = math.sqrt(sum((b ** 2).sum().item() for b in grads_p))
    tok_err = abs(tok_k - tok_p) / abs(tok_p)
    n = next(iter(next(iter(batch.values())).values())).shape[0]
    print(f"B={n} step, kernels vs plain versions: CE per target token {tok_k:.6f} vs "
          f"{tok_p:.6f} (rel {tok_err:.2e}; the training loss {loss_k:.6f} vs {loss_p:.6f}, rel "
          f"{abs(loss_k - loss_p) / abs(loss_p):.2e}), gradient rel L2 difference {num / den:.2e}")
    if not math.isfinite(loss_k) or tok_err > STEP_LOSS_RTOL or num / den > STEP_GRAD_REL_L2:
        raise AssertionError("the training step with the kernels disagrees with the plain one")
    model.zero_grad(set_to_none=True)


def _head_live_shares(model, batch, n_tokens=2048):
    """[(V, share of live rows)] of each flash-CE call in one forward of the
    model on `batch` (the rows of weight 0 are the other modalities')."""
    import egom2p_torch.ops.flash_ce as fce
    shares, real = [], fce.row_stats

    def record(y, w, targets, live=None):
        shares.append((w.shape[0], 1.0 if live is None else live.float().mean().item()))
        return real(y, w, targets, live=live)

    record.launches = real.launches  # `real` counts its launch on the module's row_stats
    fce.row_stats = record
    try:
        with torch.no_grad():
            model(batch, n_tokens, n_tokens, "mod")
    finally:
        fce.row_stats = real
        real.launches = record.launches
    return shares


def train_run(dev, label, model_name, batch, expected, flops_per_sample, plain_kind,
              steps=TRAIN_STEPS, extra=()):
    """`steps` steps of the port's trainer at cfgs/egom2p/main_mod4.yaml's
    settings (and the arguments `extra`), checked; then, where `plain_kind`
    is given, a profiled step and the one-batch step check.  Returns
    (launch totals, median step ms, peak GiB, the first step's metrics)."""
    from egom2p_torch.cli import run_training
    from egom2p_torch.data.loader import batch_to_device
    from egom2p_torch.models.egom2p import create_model

    with tempfile.TemporaryDirectory() as out_dir:
        args = run_training.get_args([
            "--synthetic_data", "--model", model_name,
            "--num_input_tokens", "2048", "--num_target_tokens", "2048", "--loss_type", "mod",
            "--batch_size", str(batch), "--accum_steps", "1", "--blr", "1e-4", "--min_blr", "0",
            "--opt_betas", "0.9", "0.95", "--weight_decay", "0.05", "--clip_grad", "1.0",
            "--lr_schedule", "constant", "--epochs", "1", "--eval_freq", "0",
            "--epoch_size", str(batch * steps),
            "--seed", "0", "--output_dir", out_dir, "--print_freq", "1", *extra])
        per_step = []
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        last = _counts()

        def on_step(step, metrics, seconds):
            now = _counts()
            per_step.append(({k: now[k] - last[k] for k in now}, metrics, seconds))
            last.update(now)

        out = run_training.main(args, on_step=on_step)
        totals = _counts()
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        ckpt_ok = (torch.load(f"{out_dir}/checkpoint-final.pth", map_location="cpu",
                              mmap=True, weights_only=False)["step"] == steps)
    if not ckpt_ok or len(per_step) != steps:
        raise AssertionError(f"{label}: {len(per_step)} steps ran, checkpoint ok: {ckpt_ok}")
    for step, (launches, metrics, _) in enumerate(per_step):
        if launches != expected:
            raise AssertionError(f"{label} step {step} launched {launches}, expected {expected}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{label} step {step}: non-finite metrics {metrics}")
    _check_first_losses(label, per_step)
    model = out["model"]
    init = create_model(args.model, sorted(run_training.MODS4), sorted(run_training.MODS4),
                        device=dev)
    init.init_random_(torch.Generator(device=dev).manual_seed(args.seed))
    moved = [not torch.equal(a, b) for a, b in zip(model.parameters(), init.parameters())]
    del init
    if not all(moved):
        raise AssertionError(f"{label}: {moved.count(False)} parameter tensors did not move")
    timed = [s for _, _, s in per_step[1:]]
    step_ms = float(np.median(timed)) * 1e3
    tflop = batch * flops_per_sample / 1e12
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{label} train steps ms: " + " ".join(f"{s * 1e3:.1f}" for _, _, s in per_step)
          + f"  (first is warm-up); losses " + " ".join(f"{m['loss']:.4f}" for _, m, _ in per_step))
    print(f"{label} ({n_params / 1e6:.1f}M params, batch {batch}): train step median "
          f"{step_ms:.1f} ms, {batch * 4096 / step_ms * 1e3:.0f} tokens/s, "
          f"peak memory {peak_gib:.2f} GiB, model {tflop:.2f} TFLOP/step = "
          f"{tflop / step_ms * 1e3:.1f} TFLOP/s, {tflop / step_ms * 1e3 / BF16_PEAK_TFLOPS:.1%} "
          f"of the card's dense bf16 peak ({BF16_PEAK_TFLOPS:.0f} TFLOP/s); "
          f"launches per step {expected}")
    if plain_kind is None:
        del out, model
        torch.cuda.empty_cache()
        return totals, step_ms, peak_gib, per_step[0][1]
    loader, _ = run_training.setup_data(args)
    it = iter(loader)
    data = batch_to_device(next(it), dev)
    it.close()
    profile_step(model, out["optimizer"], data, step_ms)
    del out
    shares = _head_live_shares(model, data)
    print(f"{label}: live rows of each flash-CE head on one batch: "
          + (", ".join(f"V={v} {share:.1%}" for v, share in shares) or "no flash-CE head"))
    step_check(model, data, expected, _plain_versions(plain_kind))
    del model, data
    torch.cuda.empty_cache()
    return totals, step_ms, peak_gib, per_step[0][1]



def train_slice_phase(dev):
    """Phase 5: (launch totals, median step ms, the first step's metrics)."""
    totals, step_ms, _, first = train_run(dev, "EgoM2P-base", BASE_MODEL, B, DEFAULT_STEP,
                                          train_flops_per_sample(), "default")
    return totals, step_ms, first


def fused_train_phase(dev, default_ms):
    """The base training run with both fused backward kernels switched on
    for this phase only."""
    with _env(EGOM2P_F64T_FUSED_BWD="1", EGOM2P_CE_PALLAS_BWD="1"):
        totals, step_ms, _, _ = train_run(dev, "EgoM2P-base, fused backwards", BASE_MODEL, B,
                                       FUSED_STEP, train_flops_per_sample(), "fused")
    print(f"fused backwards: step {step_ms:.1f} ms vs {default_ms:.1f} ms with the split "
          f"attention backward and the plain CE backward ({step_ms / default_ms - 1:+.1%})")
    return totals, step_ms


WIDE_CE_MODEL = "egom2p_large_24e_24d_gelu"   # dim 1024, 16 heads of 64
WIDE_CE_B, WIDE_CE_DEPTH, WIDE_CE_TOKENS = 2, 2, 256
# dim 1024 takes no 3-D video posemb (dim % 6): the model's modalities are
# image-token grids of 14 x 14 (2-D posemb), vocabularies 16384 to 4096
WIDE_CE_MODS = ("tok_rgb@224", "tok_depth@224", "tok_normal@224", "tok_semseg@224")
# 2 encoder self-attentions, 2 decoder self- and 2 cross-attentions; the four
# heads on flash CE, forward and (switched on) backward
WIDE_CE_STEP = dict(fwd=6, dq=6, dkv=6, dqkv=0, ce_fwd=4, ce_bwd=4, stock_fwd=0, stock_bwd=0)


def wide_ce_step_phase(dev):
    """One training step of a registry model of dim 1024
    (egom2p_large_24e_24d_gelu at 2 + 2 blocks, batch 2, 256 + 256 tokens of
    four image-token modalities) with its CE heads on both flash-CE kernels
    (EGOM2P_CE_PALLAS_BWD=1): y streamed beside W in the forward, two column
    groups of 512 in the backward; loss and gradients against the same step
    on the plain versions."""
    from egom2p_torch.data.loader import DatasetStream, MixtureLoader, batch_to_device
    from egom2p_torch.data.masking import UnifiedMasking
    from egom2p_torch.data.modality_info import MODALITY_INFO
    from egom2p_torch.models.egom2p import create_model

    info = {m: dict(MODALITY_INFO[m], input_alphas=[0.01, 0.1, 1.0, 10.0],
                    target_alphas=[0.01, 0.1, 1.0, 10.0]) for m in WIDE_CE_MODS}
    masking = UnifiedMasking(info, WIDE_CE_TOKENS, WIDE_CE_TOKENS,
                             sampling_weights=[1.0] * 4, seed=0)
    rng = np.random.default_rng(0)
    pool = [{m: rng.integers(0, info[m]["vocab_size"], size=info[m]["max_tokens"]).astype(
        np.int32) for m in WIDE_CE_MODS} for _ in range(8)]
    it = iter(MixtureLoader([DatasetStream(lambda: iter(pool), masking)], info, WIDE_CE_B))
    data = batch_to_device(next(it), dev)
    it.close()
    model = create_model(WIDE_CE_MODEL, WIDE_CE_MODS, WIDE_CE_MODS, modality_info=info,
                         device=dev, encoder_depth=WIDE_CE_DEPTH, decoder_depth=WIDE_CE_DEPTH)
    model.init_random_(torch.Generator(device=dev).manual_seed(0))
    with _env(EGOM2P_CE_PALLAS_BWD="1"):
        step_check(model, data, WIDE_CE_STEP, _plain_versions("wide_ce"),
                   n_tokens=WIDE_CE_TOKENS)
    del model, data
    torch.cuda.empty_cache()


def large_train_phase(dev):
    """EgoM2P-large at full width and depth: every attention on the stock
    route's kernels at head_dim 80 (heads of 68 zero-padded)."""
    return train_run(dev, "EgoM2P-large", LARGE_MODEL, LARGE_B, LARGE_STEP,
                     train_flops_per_sample(n_layers=24, dim=1020, h=int(2 * 4 * 1020 / 3)),
                     "large")[:2]


# ---------------------------------------------------------------- phase 5b
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
# the released token shapes and vocabularies, by the registry's shard directory
SHARD_MODS = {"tok_rgb": ("rgb", (5, 32, 32), 64000), "tok_depth": ("depth", (5, 32, 32), 64000),
              "tok_cam": ("cam", (30,), 256), "tok_gaze": ("gaze", (30,), 256)}
SHARDS, SHARD_SAMPLES = 4, 16           # train shards x samples; one held-out shard of 16
SHARD_EPOCHS, SHARD_STEPS = 2, 4
SHARD_WORKERS, SHARD_EVAL_ITERS = 2, 2
LOADER_BATCHES = 24                     # timed batches of the loader alone
# cfgs/egom2p/data_mod4.yaml and cfgs/alphas/mod4_uniform.yaml key for key,
# and main_mod4.yaml's settings as arguments: used where PyYAML is missing
DATA_MOD4 = {"train": {"datasets": {"example": {
    "type": "multimodal", "in_domains": "tok_rgb-tok_depth-tok_gaze-tok_cam",
    "out_domains": "tok_rgb-tok_depth-tok_gaze-tok_cam", "input_alphas": None,
    "target_alphas": None, "alphas_config": "cfgs/alphas/mod4_uniform.yaml",
    "num_input_tokens": 2048, "num_target_tokens": 2048,
    "data_path": "/data/tokens/[rgb,depth,cam,gaze]/example/shard-{000000..000195}.tar",
    "use_wds": True, "wds_n_repeats": 4, "wds_shuffle_buffer_tar": 1000}},
    "weights": [1.0]}}
_ALPHAS4 = {"input_alphas": [0.01, 0.1, 1.0, 10.0], "target_alphas": [0.01, 0.1, 1.0, 10.0]}
ALPHAS_MOD4 = {"sampling_weights": [1.0, 1.0, 1.0, 1.0],
               "alphas_mixture": {m: dict(_ALPHAS4) for m in
                                  ("tok_rgb", "tok_depth", "tok_gaze", "tok_cam")}}
MAIN_MOD4_ARGS = ["--run_name", "auto", "--num_input_tokens", "2048", "--num_target_tokens",
                  "2048", "--loss_type", "mod", "--model", BASE_MODEL,
                  "--use_act_checkpoint", "false", "--total_tokens", "500", "--blr", "0.0001",
                  "--min_blr", "0", "--warmup_epochs", "-1", "--warmup_tokens", "10",
                  "--batch_size", "8", "--accum_steps", "1", "--clip_grad", "1",
                  "--eval_freq", "1", "--save_ckpt_freq", "1"]
NO_LAUNCHES = {k: 0 for k in DEFAULT_STEP}
# one eval pass of SHARD_EVAL_ITERS batches: validation at 2048 + 2048 runs
# the training forward kernel (no backward) and both 64k heads' CE forward;
# fixed eval at 128 + 128 takes the dense attention (128 * 128 < 256^2, as
# in JAX), its heads still flash CE
VAL_PASS = dict(NO_LAUNCHES, fwd=36 * SHARD_EVAL_ITERS, ce_fwd=2 * SHARD_EVAL_ITERS)
FIXED_PASS = dict(NO_LAUNCHES, ce_fwd=2 * SHARD_EVAL_ITERS)


def write_shards(root, name, n_shards, per_shard, seed, captions=False):
    """Aligned shards root/<rgb|depth|cam|gaze>/<name>/shard-NNNNNN.tar of
    seeded tokens at the released shapes, as prepare_aligned_shards.py
    writes them, and with `captions` root/caption/<name>/... of `.txt`
    captions of CAPTION_WORDS (drawn from a generator of their own);
    returns (the data_path pattern, the set of the samples' tok_rgb
    bytes)."""
    import io
    import tarfile
    rng = np.random.default_rng(seed)
    words = np.random.default_rng(seed + 1000)
    prints = set()
    for shard in range(n_shards):
        samples = [{m: rng.integers(0, vocab, shape).astype(np.int32)
                    for m, (_, shape, vocab) in SHARD_MODS.items()} for _ in range(per_shard)]
        prints |= {smp["tok_rgb"].tobytes() for smp in samples}
        for m, (sub, _, _) in SHARD_MODS.items():
            d = os.path.join(root, sub, name)
            os.makedirs(d, exist_ok=True)
            with tarfile.open(os.path.join(d, f"shard-{shard:06d}.tar"), "w") as tar:
                for j, smp in enumerate(samples):
                    buf = io.BytesIO()
                    np.savez(buf, smp[m])
                    info = tarfile.TarInfo(f"{name}_{shard:06d}_{j:04d}.npz")
                    info.size = buf.tell()
                    buf.seek(0)
                    tar.addfile(info, buf)
        if captions:
            d = os.path.join(root, "caption", name)
            os.makedirs(d, exist_ok=True)
            with tarfile.open(os.path.join(d, f"shard-{shard:06d}.tar"), "w") as tar:
                for j in range(per_shard):
                    text = " ".join(CAPTION_WORDS[i] for i in words.integers(
                        0, len(CAPTION_WORDS), words.integers(8, 60))).encode()
                    info = tarfile.TarInfo(f"{name}_{shard:06d}_{j:04d}.txt")
                    info.size = len(text)
                    tar.addfile(info, io.BytesIO(text))
    subs = "rgb,depth,cam,gaze" + (",caption" if captions else "")
    return (f"{root}/[{subs}]/{name}/shard-{{000000..{n_shards - 1:06d}}}.tar", prints)


def shard_configs(tmp, train_pattern, val_pattern):
    """A JSON data config mirroring cfgs/egom2p/data_mod4.yaml on the shards
    at `train_pattern` plus a `val` section on `val_pattern`, and the main
    config's arguments: the repo's YAML files where PyYAML is installed,
    else their JSON copies above.  Returns (data config path, arguments,
    dataset name)."""
    try:
        import yaml
    except ImportError:
        yaml = None
    if yaml is not None:
        with open(os.path.join(REPO_DIR, "cfgs/egom2p/data_mod4.yaml")) as f:
            data = yaml.safe_load(f)
        alphas = os.path.join(REPO_DIR, "cfgs/alphas/mod4_uniform.yaml")
        main_args = ["--config", os.path.join(REPO_DIR, "cfgs/egom2p/main_mod4.yaml")]
    else:
        data = json.loads(json.dumps(DATA_MOD4))
        alphas = os.path.join(tmp, "mod4_uniform.json")
        with open(alphas, "w") as f:
            json.dump(ALPHAS_MOD4, f)
        main_args = list(MAIN_MOD4_ARGS)
    (name, dataset), = data["train"]["datasets"].items()
    dataset.update(data_path=train_pattern, alphas_config=alphas)
    data["val"] = {"datasets": {name: {"data_path": val_pattern}}}
    path = os.path.join(tmp, "data_mod4.json")
    with open(path, "w") as f:
        json.dump(data, f)
    print("shard phase configs: " + ("cfgs/egom2p/main_mod4.yaml, data_mod4.yaml and "
                                      "alphas/mod4_uniform.yaml through PyYAML" if yaml else
                                      "JSON copies of cfgs/egom2p/{main,data}_mod4.yaml and "
                                      "cfgs/alphas/mod4_uniform.yaml (no PyYAML here)"))
    return path, main_args, name


def _batch_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[m][k], b[m][k])
                                        for m in a for k in a[m])


def _check_first_losses(label, per_step):
    """A modality's loss is exactly 0 in a batch that holds none of its
    targets (the Dirichlet budgets often give cam and gaze none): each is
    checked at the first step that has its targets."""
    for mod, vocab in (("tok_rgb", 64000), ("tok_depth", 64000), ("tok_cam", 256),
                       ("tok_gaze", 256)):
        losses = [m[f"loss_{mod}"] for _, m, _ in per_step if m[f"loss_{mod}"] != 0.0]
        if not losses or abs(losses[0] - math.log(vocab)) > 0.5:
            raise AssertionError(f"{label} {mod}: first losses {losses[:1]}, ln {vocab} = "
                                 f"{math.log(vocab):.3f}")


def shard_train_phase(dev, synthetic_ms):
    """Phase 5b (docstring): the trainer on aligned token shards with forked
    workers, validation and fixed eval; the shard step profiled with its
    data; the loader alone; a frozen-trunk run.  Returns the launch totals
    of the shard run."""
    import egom2p_torch.data.loader as loader_mod
    from egom2p_torch.cli import run_training

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train_pattern, train_prints = write_shards(tmp, "example", SHARDS, SHARD_SAMPLES, 0)
        val_pattern, val_prints = write_shards(tmp, "held_out", 1, SHARD_SAMPLES, 1)
        data_config, main_args, name = shard_configs(tmp, train_pattern, val_pattern)
        out_dir = os.path.join(tmp, "out")
        argv = [*main_args, "--data_config", data_config, "--num_workers", str(SHARD_WORKERS),
                "--lr_schedule", "constant", "--epochs", str(SHARD_EPOCHS),
                "--epoch_size", str(B * SHARD_STEPS), "--eval_iters", str(SHARD_EVAL_ITERS),
                "--seed", "0", "--output_dir", out_dir, "--print_freq", "1",
                "--save_ckpt_freq", str(SHARD_EPOCHS + 1)]
        args = run_training.get_args(argv)
        if (args.model, args.batch_size, args.use_act_checkpoint) != (BASE_MODEL, B, False):
            raise AssertionError(f"main_mod4's settings not taken: {args}")
        phase = {"name": "train", "batches": {}}
        evals, per_step = [], []
        real_to_device, real_eval = loader_mod.batch_to_device, run_training.run_eval

        def to_device(batch, device):
            phase["batches"].setdefault(phase["name"], []).append(batch)
            return real_to_device(batch, device)

        def run_eval(factory, eval_step, prefix, *rest):
            phase["name"] = prefix
            before = _counts()
            t0 = time.perf_counter()
            stats = real_eval(factory, eval_step, prefix, *rest)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            after = _counts()
            evals.append((prefix, {k: after[k] - before[k] for k in after},
                          phase["batches"].pop(prefix), seconds))
            phase["name"] = "train"
            last.update(after)
            return stats

        def on_step(step, metrics, seconds):
            now = _counts()
            per_step.append(({k: now[k] - last[k] for k in now}, metrics, seconds))
            last.update(now)

        loader_mod.batch_to_device, run_training.run_eval = to_device, run_eval
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        last = _counts()
        try:
            out = run_training.main(args, on_step=on_step)
        finally:
            loader_mod.batch_to_device, run_training.run_eval = real_to_device, real_eval
        totals = _counts()
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        with open(os.path.join(out_dir, "log.txt")) as f:
            records = [json.loads(line) for line in f]

        # the run: launches, losses, the samples each step and eval read
        label = "EgoM2P-base on shards"
        if len(per_step) != SHARD_EPOCHS * SHARD_STEPS:
            raise AssertionError(f"{label}: {len(per_step)} steps ran")
        for step, (launches, metrics, _) in enumerate(per_step):
            if launches != DEFAULT_STEP:
                raise AssertionError(f"{label} step {step} launched {launches}")
            if not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"{label} step {step}: non-finite metrics {metrics}")
        _check_first_losses(label, per_step)
        train_rows = [r.tobytes() for b in phase["batches"]["train"]
                      for r in b["tok_rgb"]["tensor"]]
        if (len(phase["batches"]["train"]) != len(per_step)
                or not set(train_rows) <= train_prints or set(train_rows) & val_prints):
            raise AssertionError(f"{label}: a train batch holds a sample that is not a train "
                                 "shard's, or a held-out one")
        by_prefix = {}
        for prefix, launches, batches, seconds in evals:
            by_prefix.setdefault(prefix, []).append(batches)
            want = VAL_PASS if prefix.startswith("val_") else FIXED_PASS
            if launches != want or len(batches) != SHARD_EVAL_ITERS:
                raise AssertionError(f"{label} eval {prefix}: {len(batches)} batches, "
                                     f"launches {launches}, expected {want}")
            if not {r.tobytes() for b in batches for r in b["tok_rgb"]["tensor"]} <= val_prints:
                raise AssertionError(f"{label} eval {prefix}: a sample from outside the "
                                     "held-out shard")
            print(f"{label} eval {prefix[:-1]}: {seconds * 1e3:.1f} ms for {len(batches)} "
                  f"batches, launches {({k: v for k, v in launches.items() if v})}")
        fixed = by_prefix[f"fixed_eval_{name}_"]
        if len(fixed) != SHARD_EPOCHS or not all(
                _batch_equal(a, b) for a, b in zip(fixed[0], fixed[1])):
            raise AssertionError(f"{label}: the fixed-eval batches differ between epochs")
        keys = {f"{p}_{name}_{k}" for p in ("val", "fixed_eval")
                for k in ("loss", *(f"loss_{m}" for m in sorted(SHARD_MODS)))}
        evaluated = [r for r in records if keys <= set(r)]
        if [r["epoch"] for r in evaluated] != list(range(SHARD_EPOCHS)) or not all(
                math.isfinite(r[k]) for r in evaluated for k in keys):
            raise AssertionError(f"{label}: log.txt lacks the eval losses: {records}")
        step_ms = float(np.median([s for _, _, s in per_step[1:]])) * 1e3
        print(f"{label} (B={B}, {SHARD_WORKERS} workers): train steps ms "
              + " ".join(f"{s * 1e3:.1f}" for _, _, s in per_step)
              + f"; median {step_ms:.1f} ms ({B * 4096 / step_ms * 1e3:.0f} tokens/s) against "
              f"{synthetic_ms:.1f} ms on --synthetic_data in phase 5 "
              f"({step_ms / synthetic_ms - 1:+.1%}); peak memory {peak_gib:.2f} GiB; "
              f"val {records[-1][f'val_{name}_loss']:.4f}, fixed eval "
              f"{records[-1][f'fixed_eval_{name}_loss']:.4f}")

        # one shard step with its data (next batch, copy to the card, step),
        # profiled; the workers forked from this process, whose CUDA
        # context is up
        shard_profile(dev, out["model"], out["optimizer"], args)
        del out
        torch.cuda.empty_cache()
        loader_rates(args)
        frozen_run(dev, run_training, argv)
    print(f"shard phase: {time.perf_counter() - t_phase:.1f} s")
    return totals


def shard_profile(dev, model, optimizer, args):
    from torch.profiler import ProfilerActivity, profile

    from egom2p_torch.cli import run_training
    from egom2p_torch.data.loader import batch_to_device
    from egom2p_torch.train.egom2p_train import make_train_step

    step_fn = make_train_step(model, optimizer, args.num_input_tokens, args.num_target_tokens,
                              "mod")
    gen = torch.Generator().manual_seed(7)
    it = iter(run_training.setup_data(args)[0])
    try:
        def one():
            step_fn(batch_to_device(next(it), dev), gen)
            torch.cuda.synchronize()

        one()  # the first batch waits for the workers' shuffle buffers
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            one()
            times.append((time.perf_counter() - t0) * 1e3)
        ref_ms = float(np.median(times))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        it.close()
    print(f"shard step with its data (next batch from {args.num_workers} workers, copy, step): "
          + " ".join(f"{t:.1f}" for t in times) + f" ms, median {ref_ms:.1f}")
    _device_breakdown(prof, "shard step with its data", wall_ms, ref_ms)


def loader_rates(args):
    """The shard loader alone: batches/s over LOADER_BATCHES batches after
    the first, with 0 and SHARD_WORKERS workers."""
    from egom2p_torch.cli import run_training
    for workers in (0, SHARD_WORKERS):
        args.num_workers = workers
        it = iter(run_training.setup_data(args)[0])
        try:
            next(it)
            t0 = time.perf_counter()
            for _ in range(LOADER_BATCHES):
                next(it)
            seconds = time.perf_counter() - t0
        finally:
            it.close()
        print(f"shard loader alone, {workers} workers: {LOADER_BATCHES / seconds:.2f} batches/s "
              f"of B={B} ({LOADER_BATCHES * B / seconds:.1f} samples/s)")
    args.num_workers = SHARD_WORKERS


def frozen_run(dev, run_training, argv):
    """--frozen_model_epochs 1 over 2 epochs of one step: the trunk bitwise
    its seeded init after epoch 0 and every trunk tensor moved after epoch
    1; the rest moved in epoch 0."""
    from egom2p_torch.core.optim import shared_params_mask
    from egom2p_torch.models.egom2p import create_model

    with tempfile.TemporaryDirectory() as out_dir:
        args = run_training.get_args([*argv, "--frozen_model_epochs", "1", "--epochs", "2",
                                      "--epoch_size", str(B), "--eval_freq", "0",
                                      "--output_dir", out_dir])
        init = create_model(BASE_MODEL, sorted(SHARD_MODS), sorted(SHARD_MODS), device=dev)
        init.init_random_(torch.Generator(device=dev).manual_seed(args.seed))
        start = dict(init.named_parameters())
        moved = {}

        def on_epoch(epoch, model, stats):
            trunk = shared_params_mask(model)
            moved[epoch] = {True: [], False: []}
            for n, p in model.named_parameters():
                moved[epoch][trunk[n]].append(not torch.equal(p, start[n]))

        launches = []
        last = _counts()

        def on_step(step, metrics, seconds):
            now = _counts()
            launches.append({k: now[k] - last[k] for k in now})
            last.update(now)

        run_training.main(args, on_step=on_step, on_epoch=on_epoch)
        del init, start
    torch.cuda.empty_cache()
    if (launches != [DEFAULT_STEP] * 2 or any(moved[0][True]) or not all(moved[0][False])
            or not all(moved[1][True])):
        raise AssertionError(f"frozen trunk: launches {launches}; trunk tensors moved after "
                             f"epoch 0: {sum(moved[0][True])} (0 expected), after epoch 1: "
                             f"{sum(moved[1][True])} of {len(moved[1][True])}")
    print(f"frozen trunk (--frozen_model_epochs 1): {len(moved[0][True])} trunk tensors "
          f"bitwise unchanged after epoch 0, all moved after epoch 1; the other "
          f"{len(moved[0][False])} moved in epoch 0")


# ---------------------------------------------------------------- phase 5c
REMAT_STEP = dict(DEFAULT_STEP, fwd=72)   # the forward kernel again in every block's backward
REMAT_TRAIN_STEPS = 4
LARGE_REMAT_B, LARGE_REMAT_STEPS = 8, 4
LARGE_REMAT_STEP = dict(LARGE_STEP, stock_fwd=144)


def remat_phase(dev):
    """Phase 5c (docstring): activation checkpointing.  Returns the launch
    totals of the base remat run and of EgoM2P-large's."""
    t_phase = time.perf_counter()
    base_totals, full_ms, full_gib, _ = train_run(
        dev, "EgoM2P-base, remat full", BASE_MODEL, B, REMAT_STEP, train_flops_per_sample(),
        None, steps=REMAT_TRAIN_STEPS, extra=("--use_act_checkpoint", "true"))
    remat_check(dev)
    large_totals, _, large_gib, _ = train_run(
        dev, f"EgoM2P-large, B = {LARGE_REMAT_B}, remat full", LARGE_MODEL, LARGE_REMAT_B,
        LARGE_REMAT_STEP, train_flops_per_sample(n_layers=24, dim=1020, h=int(2 * 4 * 1020 / 3)),
        None, steps=LARGE_REMAT_STEPS, extra=("--use_act_checkpoint", "true"))
    if large_gib >= 80:
        raise AssertionError(f"EgoM2P-large at B = {LARGE_REMAT_B}: {large_gib:.2f} GiB")
    print(f"remat phase: {time.perf_counter() - t_phase:.1f} s")
    return base_totals, large_totals


def remat_check(dev):
    """One batch and one set of EgoM2P-base weights at B = 8: the loss and
    every gradient of a forward and backward with remat none, full and
    dots, bitwise; the attention forward's launches, ms and peak memory of
    each; and the training forward kernel run twice on the same inputs, as
    a remat backward runs it again: o and l2 bitwise."""
    import dataclasses

    import egom2p_torch.ops.flash64_train as ft
    from egom2p_torch.cli import run_training
    from egom2p_torch.data.loader import batch_to_device
    from egom2p_torch.models.egom2p import create_model

    args = run_training.get_args(["--synthetic_data", "--batch_size", str(B), "--seed", "0"])
    it = iter(run_training.setup_data(args)[0])
    data = batch_to_device(next(it), dev)
    it.close()
    model = create_model(BASE_MODEL, sorted(SHARD_MODS), sorted(SHARD_MODS), device=dev)
    model.init_random_(torch.Generator(device=dev).manual_seed(0))
    base_cfg = model.config

    def run():
        model.zero_grad(set_to_none=True)
        loss, _ = model(data, 2048, 2048, "mod", shuffle=torch.Generator().manual_seed(3))
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach()

    ref = None
    for policy in ("none", "full", "dots"):
        model.config = dataclasses.replace(base_cfg, use_act_checkpoint=policy != "none",
                                           remat_policy="dots" if policy == "dots" else "full")
        run()
        before, held = _counts(), torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss = run()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {k: v - before[k] for k, v in _counts().items() if v - before[k]}
        times = [ms]
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        grads = [p.grad for p in model.parameters()]
        if ref is None:
            ref = (loss, [g.clone() for g in grads])
            same = True
        else:
            same = torch.equal(loss, ref[0]) and all(torch.equal(a, b)
                                                     for a, b in zip(grads, ref[1]))
        print(f"remat {policy}: forward + backward {float(np.median(times)):.1f} ms (median of "
              f"3), peak {peak / 2 ** 30:.2f} GiB ({(peak - held) / 2 ** 30:.2f} above the "
              f"weights and held tensors), loss {loss.item():.6f}, launches {launches}, loss "
              f"and every gradient bitwise those of no remat: {same}")
        want = dict(DEFAULT_STEP, fwd=36 if policy == "none" else 72)
        if not same or launches != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"remat {policy}: bitwise {same}, launches {launches}")
    model.config = base_cfg
    del model, ref, data
    torch.cuda.empty_cache()
    # the forward kernel's recompute: the encoder's shape, key padding
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(B, 2048, HEADS * 64, device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3))
    kv_blocked = torch.rand(B, 2048, device=dev, generator=g) < 0.3
    o1, l1 = ft.flash64_train_fwd(q, k, v, kv_blocked)
    o2, l2 = ft.flash64_train_fwd(q, k, v, kv_blocked)
    if not (torch.equal(o1, o2) and torch.equal(l1, l2)):
        raise AssertionError("the training forward kernel's second run differs from its first")
    print("flash64_train forward run twice on the same inputs (a remat backward's "
          "recompute): o and l2 bitwise equal")


# instances of the attention kernels: at head_dim 64 the SAFEMAX/SEG/L2
# combinations of the forward, CLAMP x SEG of dq, CLAMP x SEG x FUSED of dk/dv;
# at head_dim 80 (the stock route) the safemax L2 forward and the safemax
# fused backward, each with and without segments
WGMMA64_INSTANCES = {"flash64_fwd_kernel": 6 + 2, "flash64_dq_kernel": 4,
                     "flash64_dkv_kernel": 8 + 2, "flash_ce_fwd_kernel": 1}


# ---------------------------------------------------------------- phase 5d
# cfgs/vqvae/{cam,gaze}.yaml key for key: used where PyYAML is missing
VQVAE_CONFIGS = {domain: {
    "run_name": "auto", "encoder_type": enc, "decoder_type": enc, "domain": domain,
    "num_frames": 60, "post_mlp": True, "temporal_downsampling": 2, "codebook_size": 256,
    "latent_dim": 32, "norm_codes": True, "quantizer_type": "lucid", "coef_ema_dead_code": 32.0,
    "code_replacement_policy": "batch_random", "commitment_weight": 1.0,
    "quantizer_ema_decay": 0.99, "kmeans_init": False, "loss_fn": loss, "codebook_weight": 1.0,
    "dtype": "fp32", "epochs": 200, "opt": "adamw", "opt_betas": [0.9, 0.99], "blr": blr,
    "warmup_lr": 0.000001, "min_lr": 0.0, "warmup_epochs": 5, "batch_size": 128,
    "clip_grad": 1.0, "save_ckpt_freq": 10, "output_dir": f"output/vqvae_{domain}",
    "log_wandb": False}
    for domain, enc, loss, blr in (("cam", "CamTransformer", "mse", 0.000025),
                                   ("gaze", "GazeTransformer", "mse_mask", 0.00005))}
VQ_SAMPLES, VQ_B, VQ_STEPS = 1024, 128, 8   # 1024 trajectories at B = 128: 8 steps an epoch
VQ_WIDTH = (768, 12)                    # the configs' dim and depth (the flags' defaults)
PIPE_CLIPS = 16                         # clips of the tokenizer chain, 2 batches of 8
FP32_PEAK_TFLOPS, TF32_PEAK_TFLOPS = 67.0, 495.0   # H100 SXM dense, NVIDIA's data sheet
TF32_STEPS = 3
# the chain's first step, each modality's loss against the plain versions'
# forward on the same step: bf16 attention in another order, as in
# step_check (whose CE over single samples moved by up to 1e-3 relative)
CHAIN_LOSS_RTOL = 2e-3


def seq_vqvae_train_flops(dim=768, depth=12, tokens=30, channels=9, latent=32, codes=256):
    """Model FLOPs of one VQ-VAE training sample: the products of the forward
    (the patch conv and the output projection over 2 frames a token, the
    encoder and decoder blocks with their attention over `tokens`, the
    post-MLPs, the quant projections, the codebook lookup) times 3."""
    block = 24 * dim ** 2 + 4 * tokens * dim            # qkv, proj, MLP 4x; QK^T and AV
    per_token = 2 * depth * block + 2 * 16 * dim ** 2 + 4 * dim * latent
    per_token += 2 * 2 * 2 * channels * dim + 2 * codes * latent
    return 3 * tokens * per_token


def vqvae_configs(tmp):
    """The cam / gaze configs: the repo's YAML files where PyYAML is
    installed, else JSON copies of them."""
    try:
        import yaml  # noqa: F401
        paths = {d: os.path.join(REPO_DIR, f"cfgs/vqvae/{d}.yaml") for d in VQVAE_CONFIGS}
    except ImportError:
        paths = {}
        for d, cfg in VQVAE_CONFIGS.items():
            paths[d] = os.path.join(tmp, f"vqvae_{d}.json")
            with open(paths[d], "w") as f:
                json.dump(cfg, f)
    print("tokenizer phase configs: " + ("cfgs/vqvae/{cam,gaze}.yaml through PyYAML"
                                         if paths["cam"].endswith(".yaml") else
                                         "JSON copies of cfgs/vqvae/{cam,gaze}.yaml (no PyYAML)"))
    return paths


def _vq_launches():
    from egom2p_torch.ops.flash64 import flash64_attention
    return {**_counts(), "flash64": flash64_attention.launches}


def vqvae_train_run(dev, tmp, domain, config, data_path):
    """Train one tokenizer at its config's settings for one epoch and eval
    through run_training_vqvae.main, then resume it for a second epoch;
    check it and print its numbers.  Returns (the checkpoint, the trained
    tokenizer, the run's args)."""
    import egom2p_torch.ops.vq as vq_mod
    from egom2p_torch.cli import run_training_vqvae as rtv

    out_dir = os.path.join(tmp, f"vqvae_{domain}")
    base = ["--config", config, "--data_path", data_path, "--output_dir", out_dir,
            "--device", "cuda", "--print_freq", "4", "--seed", "0"]
    args = rtv.get_args(base + ["--epochs", "1"])
    if (args.batch_size, args.vq_dim, args.vq_depth, args.dtype) != (VQ_B, *VQ_WIDTH, "fp32"):
        raise AssertionError(f"the {domain} config's settings not taken: {args}")
    expired, steps = [], []
    real_update = vq_mod._updated_state

    def counting(cfg, *a):
        new = real_update(cfg, *a)
        expired.append(int((new.cluster_size < cfg.threshold_ema_dead_code).sum()))
        return new

    vq_mod._updated_state = counting
    _reset_counts()
    from egom2p_torch.ops.flash64 import flash64_attention
    flash64_attention.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        t0 = time.perf_counter()
        first = rtv.main(base + ["--epochs", "1"], on_step=lambda s, m, sec: steps.append((m, sec)))
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = rtv.main(base + ["--epochs", "2"], on_step=lambda s, m, sec: steps.append((m, sec)))
        t_resume = time.perf_counter() - t0
    finally:
        vq_mod._updated_state = real_update
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launches = _vq_launches()
    label = f"{domain} VQ-VAE (B = {args.batch_size}, exact fp32)"
    if any(launches.values()):
        raise AssertionError(f"{label}: kernel launches {launches} (the dense path expected)")
    if len(steps) != 2 * VQ_STEPS or not all(math.isfinite(v) for m, _ in steps
                                             for v in m.values()):
        raise AssertionError(f"{label}: {len(steps)} steps, metrics {[m for m, _ in steps]}")
    if not any(expired):
        raise AssertionError(f"{label}: no code expired and was replaced")
    with open(os.path.join(out_dir, "log.txt")) as f:
        records = [json.loads(line) for line in f]
    if [r["epoch"] for r in records] != [0, 1] or not all(
            math.isfinite(r[k]) for r in records for k in ("eval_loss", "eval_mse",
                                                           "eval_codebook_usage")):
        raise AssertionError(f"{label}: log.txt {records}")
    tok = res["tokenizer"]
    init = rtv.build_tokenizer(args, dev, torch.Generator(dev).manual_seed(args.seed))
    still = [n for n, p in tok.net.named_parameters()
             if torch.equal(p, dict(init.net.named_parameters())[n])]
    cb, cb0 = tok.net.quantize.state, init.net.quantize.state
    if still or torch.equal(cb.embed, cb0.embed) or torch.equal(cb.cluster_size, cb0.cluster_size):
        raise AssertionError(f"{label}: unmoved parameters {still[:5]} or codebook")
    del init
    ckpt = os.path.join(out_dir, "checkpoint-final.pth")
    t0 = time.perf_counter()
    loaded = rtv.load_tokenizer_state(args, ckpt, dev)  # load_seq_vqvae_pth at the flags' widths
    t_load = time.perf_counter() - t0
    if any(not torch.equal(v, loaded.net.state_dict()[k])
           for k, v in tok.net.state_dict().items()):
        raise AssertionError(f"{label}: the checkpoint does not load back bitwise")
    del loaded, first
    times = [s for _, s in steps]
    step_ms = float(np.median(times[1:VQ_STEPS] + times[VQ_STEPS + 1:])) * 1e3
    flops = seq_vqvae_train_flops(channels=tok.net.encoder.in_channels) * args.batch_size
    n_params = sum(p.numel() for p in tok.net.parameters())
    print(f"{label}: {n_params / 1e6:.1f}M params; steps ms "
          + " ".join(f"{s * 1e3:.1f}" for s in times)
          + f"; median {step_ms:.1f} ms ({args.batch_size / step_ms * 1e3:.0f} samples/s, "
          f"{flops / step_ms / 1e9:.1f} TFLOP/s = {flops / step_ms / 1e9 / FP32_PEAK_TFLOPS:.1%} "
          f"of the {FP32_PEAK_TFLOPS:.0f} TFLOP/s FP32 peak, bound "
          f"{flops / FP32_PEAK_TFLOPS / 1e9:.1f} ms); peak memory {peak_gib:.2f} GiB; expired "
          f"codes a step {expired}; losses {steps[0][0]['loss']:.4f} -> {steps[-1][0]['loss']:.4f};"
          f" eval {records[-1]['eval_loss']:.4f}, usage {records[-1]['eval_codebook_usage']:.3f}; "
          f"runs {t_first:.1f} s + resumed {t_resume:.1f} s, checkpoint "
          f"{os.path.getsize(ckpt) / 2 ** 30:.2f} GiB loaded back bitwise in {t_load:.1f} s; "
          f"launches {launches}")
    return ckpt, res, args, step_ms, flops


def vqvae_tf32(dev, domain, res, args, step_ms, flops, fixed):
    """After the run: the tokens of a fixed batch that TF32 changes, the
    step's time on TF32 beside exact fp32 (in turns, on the trained model)
    and, for cam, one exact-fp32 step's device time by kernel class."""
    from egom2p_torch.train.vqvae_train import make_vqvae_train_step
    tok = res["tokenizer"]
    exact = tok.tokenize(fixed)
    tok.tf32 = True
    tf32 = tok.tokenize(fixed)
    tok.tf32 = False
    step = make_vqvae_train_step(tok.net, res["optimizer"], args.loss_fn, args.codebook_weight)
    gen = torch.Generator(dev).manual_seed(5)
    batch = torch.from_numpy(fixed[:args.batch_size]).to(dev)
    times = {False: [], True: []}
    for allow in (False, True, True, False) * TF32_STEPS:
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        metrics = step(batch, generator=gen)
        float(metrics["loss"])
        times[allow].append((time.perf_counter() - t0) * 1e3)
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = {k: float(np.median(v)) for k, v in times.items()}
    if domain == "cam":  # one exact-fp32 step under the profiler
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(step(batch, generator=gen)["loss"])
            wall_ms = (time.perf_counter() - t0) * 1e3
        _device_breakdown(prof, f"{domain} VQ-VAE step", wall_ms, ms[False])
    print(f"{domain} VQ-VAE step on TF32 {ms[True]:.1f} ms ({flops / ms[True] / 1e9:.1f} TFLOP/s, "
          f"{flops / ms[True] / 1e9 / TF32_PEAK_TFLOPS:.1%} of the {TF32_PEAK_TFLOPS:.0f} TFLOP/s "
          f"TF32 peak) against exact fp32 {ms[False]:.1f} ms in turns ({step_ms:.1f} in the run); "
          f"TF32 changes {int((exact != tf32).sum())} of {exact.numel()} tokens of a fixed batch "
          f"of {len(fixed)}")


def video_batches(dev, tmp, tokenize_videos, keys):
    """rgb and depth tokens of PIPE_CLIPS staged seeded uint8 clips through
    tokenize_videos.write_batch at full width (DV4x8x8, 256 px, 16 frames,
    batches of 8), read back and held against forward's; extracted to
    per-key .npz directories.  Returns {modality: directory}."""
    import tarfile
    args = tokenize_videos.get_args(["--input", tmp, "--output-dir", tmp, "--smoke",
                                     "--device", "cuda"])
    tok = tokenize_videos.load_tokenizer(args, dev)
    rng = np.random.default_rng(11)
    dirs, per_batch = {}, []
    for mod in ("rgb", "depth"):
        clips = rng.integers(0, 256, (PIPE_CLIPS, args.max_frames, args.size, args.size, 3),
                             dtype=np.uint8)
        tok.forward(clips[:B])  # warm-up
        out_dir = os.path.join(tmp, f"{mod}_tars")
        os.makedirs(out_dir)
        with tarfile.open(os.path.join(out_dir, "shard-000000.tar"), "w") as tar:
            for i in range(0, PIPE_CLIPS, B):
                batch = [(keys[j], clips[j], "shard-000000.tar") for j in range(i, i + B)]
                t0 = time.perf_counter()
                tokenize_videos.write_batch(tok, batch, lambda name: tar,
                                            args.temporal_window)
                per_batch.append((time.perf_counter() - t0) * 1e3)
        dirs[mod] = os.path.join(tmp, f"{mod}_npz")
        with tarfile.open(os.path.join(out_dir, "shard-000000.tar")) as tar:
            tar.extractall(dirs[mod], filter="data")
        for i in range(0, PIPE_CLIPS, B):
            want = tok.forward(clips[i:i + B], temporal_window=args.temporal_window)
            got = np.stack([np.load(os.path.join(dirs[mod], f"{k}.npz"))["arr_0"]
                            for k in keys[i:i + B]])
            if got.dtype != np.int32 or got.shape != (B, 5, 32, 32) or not np.array_equal(
                    got, want):
                raise AssertionError(f"tokenize_videos {mod}: the tar's tokens differ from "
                                     f"forward's ({got.dtype}, {got.shape})")
    del tok
    torch.cuda.empty_cache()
    print(f"tokenize_videos write_batch (DV4x8x8, B = {B}, {args.max_frames} x {args.size}^2, "
          f"exact fp32 network): ms per batch " + " ".join(f"{t:.1f}" for t in per_batch)
          + f", median {np.median(per_batch):.1f} ms; tokens read back from the tars equal "
          "forward's")
    return dirs


def _plain_first_losses(real_make, plain):
    """make_train_step whose first step runs, before its own, the forward
    on the plain versions of the kernels (without gradient: the route does
    not depend on it) with the step's batch, weights and decoder order (the
    CPU generator's state copied), and records each modality's loss in
    `plain`."""
    def make(model, optimizer, n_in, n_tgt, loss_type="mod", accum_steps=1):
        step = real_make(model, optimizer, n_in, n_tgt, loss_type, accum_steps)

        def first(batch, shuffle=None):
            if not plain:
                if accum_steps != 1 or shuffle is None:
                    raise AssertionError("the plain first step needs one micro-batch and "
                                         "the step's generator")
                order = torch.Generator()
                order.set_state(shuffle.get_state())
                model.train()
                with _swapped(_plain_versions("default")), torch.no_grad():
                    _, mod_loss = model(batch, n_in, n_tgt, loss_type, shuffle=order)
                plain.update({f"loss_{m}": v.item() for m, v in mod_loss.items()})
            return step(batch, shuffle)
        return first
    return make


def tokenizer_pipeline_phase(dev):
    """Phase 5d (docstring): the tokenizer half of training at full width,
    end to end into the trainer.  Returns the launch totals of its
    pretraining run."""
    from egom2p_torch.cli import run_training, tokenize_videos
    from egom2p_torch.cli import run_training_vqvae as rtv
    from egom2p_torch.train import egom2p_train
    from egom2p_torch.data.cam_gaze import smooth_cam_trajectories, smooth_gaze_tracks

    t_phase = time.perf_counter()
    torch.cuda.init()  # the memory statistics below need the context up
    with tempfile.TemporaryDirectory() as tmp:
        configs = vqvae_configs(tmp)
        rng = np.random.default_rng(21)
        train = {"cam": smooth_cam_trajectories(rng, VQ_SAMPLES)[1].astype(np.float32),
                 "gaze": smooth_gaze_tracks(rng, VQ_SAMPLES)}
        keys = [f"ego_{i:02d}" for i in range(PIPE_CLIPS)]
        mods = {}
        for domain, data in train.items():
            data_path = os.path.join(tmp, f"{domain}_train.npy")
            np.save(data_path, data)
            ckpt, res, args, step_ms, flops = vqvae_train_run(dev, tmp, domain, configs[domain],
                                                              data_path)
            # --tokenize on the trained checkpoint: one .npy per clip of the chain
            clips_dir = os.path.join(tmp, f"{domain}_clips")
            os.makedirs(clips_dir)
            clips = [os.path.join(clips_dir, f"{k}.npy") for k in keys]
            for c, d in zip(clips, data[-PIPE_CLIPS:]):
                np.save(c, d)
            tok_argv = ["--config", configs[domain], "--tokenize", "--resume", ckpt,
                        "--tokenize_save_path", os.path.join(tmp, f"{domain}_tok"),
                        "--device", "cuda", "--tokenize_path"]
            t0 = time.perf_counter()
            outs = [rtv.main(tok_argv + [clips[0]])]  # the entry point, its checkpoint load
            t_main = time.perf_counter() - t0
            # the other files with the checkpoint loaded once
            tok_args = rtv.get_args(tok_argv + [clips[0]])
            loaded = rtv.load_tokenizer_state(tok_args, ckpt, dev)
            t0 = time.perf_counter()
            outs += [rtv.tokenize_file(tok_args, loaded, c) for c in clips[1:]]
            t_files = time.perf_counter() - t0
            del loaded
            x = np.stack([rtv.prepare_samples(args, c)[0][0] for c in clips])
            want = res["tokenizer"].tokenize(x).cpu().numpy()
            got = np.stack([np.load(p)["arr_0"] for p in outs])
            if got.dtype != np.int16 or not np.array_equal(got, want):
                raise AssertionError(f"{domain} --tokenize: tokens differ from the trained "
                                     "tokenizer's")
            for p in outs:  # the user's rename: <key>-tok.npz -> <key>.npz
                os.rename(p, p.replace("-tok.npz", ".npz"))
            mods[domain] = os.path.dirname(outs[0])
            print(f"{domain} --tokenize on the trained checkpoint: main() on one clip file "
                  f"{t_main:.1f} s with its load, then {len(clips) - 1} files "
                  f"{t_files / (len(clips) - 1) * 1e3:.1f} ms each; tokens equal the trained "
                  f"tokenizer's; {len(np.unique(got))} distinct codes")
            vqvae_tf32(dev, domain, res, args, step_ms, flops,
                       rtv.load_seq_data(args, data_path)[:args.batch_size])
            del res
            torch.cuda.empty_cache()
            if domain == "cam":
                vqvae_ranks_check(dev, tmp, configs[domain], data)
        mods.update(video_batches(dev, tmp, tokenize_videos, keys))
        shards = os.path.join(tmp, "shards")
        proc = subprocess.run([sys.executable, os.path.join(REPO_DIR, "prepare_aligned_shards.py"),
                               *(f"--modality={m}={d}" for m, d in mods.items()),
                               "--output-dir", shards, "--shard-size", str(PIPE_CLIPS)],
                              capture_output=True, text=True)
        if proc.returncode != 0 or f"aligned keys: {PIPE_CLIPS}" not in proc.stdout:
            raise AssertionError(f"prepare_aligned_shards.py: {proc.stdout}{proc.stderr}")
        pattern = f"{shards}/[rgb,depth,cam,gaze]/shard-{{000000..000000}}.tar"
        data_config, main_args, _ = shard_configs(tmp, pattern, pattern)
        argv = [*main_args, "--data_config", data_config, "--lr_schedule", "constant",
                "--epochs", "1", "--epoch_size", str(PIPE_CLIPS), "--eval_freq", "0",
                "--seed", "0", "--output_dir", os.path.join(tmp, "pretrain"), "--print_freq", "1"]
        per_step = []
        _reset_counts()
        last = _counts()

        def on_step(step, metrics, seconds):
            now = _counts()
            per_step.append(({k: now[k] - last[k] for k in now}, metrics, seconds))
            last.update(now)

        plain = {}
        real_make = egom2p_train.make_train_step
        egom2p_train.make_train_step = _plain_first_losses(real_make, plain)
        try:
            run_training.main(run_training.get_args(argv), on_step=on_step)
        finally:
            egom2p_train.make_train_step = real_make
        totals = _counts()
        label = "EgoM2P-base on the chain's shards"
        if len(per_step) != PIPE_CLIPS // B or any(l != DEFAULT_STEP for l, _, _ in per_step) \
                or not all(math.isfinite(v) for _, m, _ in per_step for v in m.values()):
            raise AssertionError(f"{label}: {per_step}")
        # the cam / gaze targets come from tokenizers 16 steps into training
        # that use a few codes, so ln V is not the first loss to expect
        # (gaze 6.08 against ln 256 = 5.55 on an H100): each modality's first
        # loss is held to the plain versions' on the same step instead
        first = per_step[0][1]
        errs = {m: abs(first[m] - v) / max(abs(v), 1e-30) for m, v in plain.items()}
        print(f"{label}: first losses, kernels vs plain versions: "
              + ", ".join(f"{m} {first[m]:.5f} vs {v:.5f}" for m, v in plain.items())
              + "; rel " + " ".join(f"{e:.2e}" for e in errs.values()))
        if sorted(plain) != sorted(k for k in first if k.startswith("loss_tok_")) \
                or max(errs.values()) > CHAIN_LOSS_RTOL:
            raise AssertionError(f"{label}: the first losses differ from the plain versions' "
                                 f"beyond {CHAIN_LOSS_RTOL}")
        print(f"{label} (B = {B}): {len(per_step)} steps, ms "
              + " ".join(f"{s * 1e3:.1f}" for _, _, s in per_step) + " (the first with its "
              "plain forward), losses " + " ".join(f"{m['loss']:.4f}" for _, m, _ in per_step)
              + f", launches a step {per_step[0][0]}")
    torch.cuda.empty_cache()
    print(f"tokenizer pipeline phase: {time.perf_counter() - t_phase:.1f} s")
    return totals


# ---------------------------------------------------------------- phase 5e
# the one-rank run over NCCL: 2 epochs of DP_EPOCH_STEPS steps at B = 8, the
# first epoch profiled, its checkpoint written on a background thread
DP_EPOCH_STEPS = 3
# the two ranks sharing the card over gloo: DP_B rows per rank, DP_STEPS
# steps at --accum_steps 1 (then a val pass), then DP_STEPS at 2
DP_B, DP_STEPS = 4, 2
DP_TIMEOUT_S = 600
DP_CONFIG = {"model": BASE_MODEL, "tokens": 2048, "device": "cuda", "scaled": False,
             "kernels": True}
FLASH_KERNEL_NAMES = ("flash64_fwd_kernel", "flash64_dq_kernel", "flash64_dkv_kernel",
                      "flash_ce_fwd_kernel")


def _dp_argv(cfg, out_dir, batch, epoch_size, epochs, *extra):
    """The trainer's arguments of phase 5's run (main_mod4.yaml's settings,
    synthetic data, constant LR, seed 0) at `cfg`'s model and size."""
    n = str(cfg["tokens"])
    return ["--synthetic_data", "--model", cfg["model"], "--num_input_tokens", n,
            "--num_target_tokens", n, "--loss_type", "mod", "--batch_size", str(batch),
            "--blr", "1e-4", "--min_blr", "0", "--opt_betas", "0.9", "0.95",
            "--weight_decay", "0.05", "--clip_grad", "1.0", "--lr_schedule", "constant",
            "--epochs", str(epochs), "--epoch_size", str(epoch_size), "--seed", "0",
            "--device", cfg["device"], "--output_dir", out_dir, "--print_freq", "1",
            *(["--scaled_modalities"] if cfg["scaled"] else []), *extra]


def _capture_optimizers(keep_grads: bool, to_host: bool = False):
    """The trainer's Optimizers, in the order it makes them; with
    `keep_grads` each keeps the gradients of its first step as it applied
    them (summed over the ranks, before clipping) in `.first_grads`, the
    full tensors on a sharded model (gathered: every rank keeps them), in
    host memory with `to_host` (out of the card's memory figures)."""
    import egom2p_torch.core.optim as optim
    made, init, step = [], optim.Optimizer.__init__, optim.Optimizer.step

    def init_(self, *a, **kw):
        init(self, *a, **kw)
        self.first_grads = None
        made.append(self)

    def step_(self):
        if keep_grads and self.first_grads is None:
            self.first_grads = [_full(self, p, p.grad).to("cpu" if to_host else p.device)
                                for p in self.params]
        return step(self)

    optim.Optimizer.__init__, optim.Optimizer.step = init_, step_
    return made


def _full(optimizer, p, t):
    """`t` (a parameter, its gradient or a moment of it) as the full tensor:
    gathered where `p` is the piece of a sharded parameter (a collective)."""
    sharded = optimizer.fsdp.sharded(p) if optimizer.fsdp is not None else None
    return (optimizer.fsdp.gather(t, sharded) if sharded is not None else t).detach().clone()


def _host_copy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _tree_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b.cpu())
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    return a == b


def _counting_on_step(per_step, after=None):
    """on_step for the trainer: each step's launches by wrapper, metrics and
    seconds into `per_step`, then `after()`."""
    _reset_counts()
    last = _counts()

    def on_step(step, metrics, seconds):
        now = _counts()
        per_step.append({"launches": {k: now[k] - last[k] for k in now}, "metrics": metrics,
                         "seconds": seconds})
        last.update(now)
        if after is not None:
            after()

    return on_step


def dp_nccl_worker(cfg, out_json):
    """Phase 5e's one-rank run, under torchrun: the trainer's main() with
    --profile, --async_save true and --save_ckpt_freq 1 over 2 epochs; writes
    each step's launches and metrics, and whether checkpoint-0.pth holds
    the model and optimizer state at its step, to `out_json`."""
    from egom2p_torch.cli import run_training
    from egom2p_torch.core.checkpoint import load_pth

    from egom2p_torch.core import fsdp

    run_dir = os.path.join(os.path.dirname(out_json), "nccl-run")
    made, per_step, snap = _capture_optimizers(keep_grads=False), [], {}
    dev = torch.device(cfg["device"])

    def on_epoch(epoch, model, stats):
        if epoch == 0:  # after its (async) save returned: no step in between
            snap["model"] = _host_copy(fsdp.full_state_dict(model))
            snap["optimizer"] = _host_copy(made[-1].state_dict())

    def memory():  # after every step: what stays between steps, the step's peak
        per_step[-1].update(_memory(dev))

    args = run_training.get_args(_dp_argv(
        cfg, run_dir, B, B * DP_EPOCH_STEPS, 2, "--accum_steps", "1", "--eval_freq", "0",
        *(["--profile"] if cfg.get("profile", True) else []), "--async_save", "true",
        "--save_ckpt_freq", "1", *(["--fsdp", "true"] if cfg.get("fsdp") else [])))
    run_training.main(args, on_step=_counting_on_step(per_step, memory), on_epoch=on_epoch)
    ckpt = load_pth(os.path.join(run_dir, "checkpoint-0.pth"))
    with open(out_json, "w") as f:
        json.dump({"steps": per_step, "ckpt_step": ckpt["step"],
                   "ckpt_equal": _tree_equal(snap["model"], ckpt["model"])
                   and _tree_equal(snap["optimizer"], ckpt["optimizer"]),
                   "trace": os.path.join(run_dir, "profile", "trace-rank0.json"),
                   "world": int(os.environ["WORLD_SIZE"])}, f)


def _per_token(metrics, counts, prefix="loss_"):
    """The modalities' losses weighted by their target counts (step_check:
    the mean of the modalities' means is noisy where one holds few
    targets)."""
    return sum(metrics[prefix + m] * c for m, c in counts.items()) / sum(counts.values())


def _target_counts(batch):
    return {m: float((~np.asarray(d["target_mask"]).astype(bool)).sum()) for m, d in batch.items()}


def dp_rank_worker(cfg, out_dir):
    """One of phase 5e's ranks (or of --cards N's): rank RANK of WORLD_SIZE.
    Over gloo (cfg["backend"]) it forms the group itself, over NCCL the
    trainer forms it from torchrun's environment; then the trainer's main()
    at --accum_steps 1 (with a val pass) and 2, checking after every step
    that its parameters equal rank 0's bitwise.  Rank 0 then leaves the
    group and steps one process on the global batch the ranks' loaders
    gave, evaluates the val pass's rows and times one process's step at
    the rank's batch.  Writes rank{RANK}.json to `out_dir`."""
    import datetime

    import torch.distributed as dist

    from egom2p_torch.cli import run_training

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if cfg["backend"] == "gloo":
        dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    made = _capture_optimizers(keep_grads=rank == 0)
    runs, kept = {}, {}
    for accum in (1, 2):
        per_step, synced, stats = [], [], {}

        def check_sync():
            flat = torch.cat([p.detach().reshape(-1) for p in made[-1].params])
            ref = flat.clone()
            dist.broadcast(ref, 0)
            synced.append(bool(torch.equal(ref, flat)))

        run_dir = os.path.join(out_dir, f"rank{rank}-accum{accum}")
        b = cfg["batch"]
        args = run_training.get_args(_dp_argv(
            cfg, run_dir, b, b * world * accum * DP_STEPS, 1, "--accum_steps", str(accum),
            "--eval_freq", "1" if accum == 1 else "0", "--eval_iters", "1", "--no_fixed_eval",
            "--async_save", "false"))
        out = run_training.main(args, on_step=_counting_on_step(per_step, check_sync),
                                on_epoch=lambda epoch, model, st: stats.update(st))
        runs[accum] = {"steps": per_step, "synced": synced, "stats": stats,
                       "world": dist.get_world_size(), "backend": dist.get_backend()}
        if rank == 0:
            kept[accum] = {"grads": made[-1].first_grads,
                           "model": out["model"] if accum == 1 else None}
        del out
    dist.destroy_process_group()
    result = {"runs": runs}
    if rank == 0:
        result["reference"] = _dp_reference(cfg, kept, runs, world)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _dp_reference(cfg, kept, runs, world):
    """One process (no group) on the global batch of the ranks' first loader
    batches: the first step's metrics and gradients against the ranks',
    the eval step on the val pass's rows against the ranks' val pass, and
    the median ms of 3 steps at one rank's batch (after one warm-up)."""
    from egom2p_torch.cli import run_training
    from egom2p_torch.core import distributed
    from egom2p_torch.core.optim import Optimizer
    from egom2p_torch.data.loader import batch_to_device
    from egom2p_torch.models.egom2p import create_model
    from egom2p_torch.train.egom2p_train import make_eval_step, make_train_step

    dev = (torch.device("cuda", distributed.local_rank()) if cfg["device"] == "cuda"
           else torch.device("cpu"))
    n, b = cfg["tokens"], cfg["batch"]
    real_rank, real_world = distributed.rank, distributed.world_size

    def model_at_init(remat):
        info = run_training.modality_info(args) if cfg["scaled"] else None
        model = create_model(cfg["model"], sorted(run_training.MODS4), sorted(run_training.MODS4),
                             device=dev, modality_info=info, use_act_checkpoint=remat)
        model.init_random_(torch.Generator(device=dev).manual_seed(0))
        return model

    out = {}
    try:
        for accum in (1, 2):
            args = run_training.get_args(_dp_argv(cfg, "unused", b, b, 1,
                                                  "--accum_steps", str(accum)))
            rows = []
            for r in range(world):  # rank r's loader: its seed, its first batch
                distributed.rank = lambda r=r: r
                it = iter(run_training.setup_data(args)[0])
                rows.append(next(it))
                it.close()
            distributed.rank = real_rank
            glob = {m: {k: np.concatenate([part[m][k] for part in rows]) for k in d}
                    for m, d in rows[0].items()}
            # remat gives the same loss and gradients bitwise (phase 5c)
            model = model_at_init(cfg["reference_remat"])
            opt = Optimizer(model, [1e-4], clip_grad=1.0)
            metrics = make_train_step(model, opt, n, n, "mod", accum)(
                batch_to_device(glob, dev), torch.Generator().manual_seed(1))
            ref = {k: float(v) for k, v in metrics.items()}
            got = runs[accum]["steps"][0]["metrics"]
            grads, ref_grads = kept[accum]["grads"], opt.first_grads
            num = math.sqrt(sum(((a.float() - b_.float()) ** 2).sum().item()
                                for a, b_ in zip(grads, ref_grads)))
            den = math.sqrt(sum((b_.float() ** 2).sum().item() for b_ in ref_grads))
            counts = _target_counts(glob)
            out[accum] = {"rows": int(glob["tok_rgb"]["tensor"].shape[0]),
                          "loss": got["loss"], "ref_loss": ref["loss"],
                          "per_token": _per_token(got, counts),
                          "ref_per_token": _per_token(ref, counts),
                          "grad_norm": got["grad_norm"], "ref_grad_norm": ref["grad_norm"],
                          "grad_rel_l2": num / den}
            del model, opt, metrics, grads, ref_grads
            kept[accum]["grads"] = None
        # the val pass: every rank read the same global batch and took its rows
        distributed.world_size = lambda: world
        args = run_training.get_args(_dp_argv(cfg, "unused", b, b, 1))
        factory = run_training.setup_val_data(args)[0]["synthetic_val"]
        distributed.world_size = real_world
        it = factory()
        val = next(it)
        it.close()
        ev = make_eval_step(kept[1]["model"], n, n, "mod")(batch_to_device(val, dev))
        ev = {f"val_synthetic_val_{k}": float(v) for k, v in ev.items()}
        counts = _target_counts(val)
        stats = runs[1]["stats"]
        out["eval"] = {"rows": int(val["tok_rgb"]["tensor"].shape[0]),
                       "loss": stats["val_synthetic_val_loss"],
                       "ref_loss": ev["val_synthetic_val_loss"],
                       "per_token": _per_token(stats, counts, "val_synthetic_val_loss_"),
                       "ref_per_token": _per_token(ev, counts, "val_synthetic_val_loss_")}
        kept.clear()
        # one process's step at one rank's batch, beside the ranks' steps
        model = model_at_init(False)
        opt = Optimizer(model, [1e-4], clip_grad=1.0)
        step = make_train_step(model, opt, n, n, "mod")
        single = batch_to_device({m: {k: v[:b] for k, v in d.items()} for m, d in val.items()},
                                 dev)
        gen, times = torch.Generator().manual_seed(1), []
        for _ in range(4):
            _sync_device(dev)
            t0 = time.perf_counter()
            step(single, gen)
            _sync_device(dev)
            times.append(time.perf_counter() - t0)
        out["single_ms"] = float(np.median(times[1:])) * 1e3
    finally:
        distributed.rank, distributed.world_size = real_rank, real_world
    return out


def _sync_device(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _trace_stats(path):
    """(kernel names found of FLASH_KERNEL_NAMES, NCCL kernels' share of the
    device kernel time, kernel ms) of a chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    total = sum(e.get("dur", 0) for e in kernels)
    nccl = sum(e.get("dur", 0) for e in kernels if "nccl" in e.get("name", "").lower())
    names = [k for k in FLASH_KERNEL_NAMES if any(k in e.get("name", "") for e in kernels)]
    return names, (nccl / total if total else 0.0), total / 1e3


def data_parallel_phase(dev, first, default_ms, cfg=None):
    """Phase 5e (docstring): the trainer across processes.  `first` is
    phase 5's first-step metrics and `default_ms` its median step ms.
    Returns the one-rank run's launch totals."""
    cfg = dict(DP_CONFIG if cfg is None else cfg)
    t_phase = time.perf_counter()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    script = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        # 1. one rank over NCCL, launched as users launch it
        out_json = os.path.join(tmp, "nccl.json")
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", "1", script, "--dp-worker", "nccl",
                               cfg_path, out_json], cwd=REPO_DIR, capture_output=True,
                              text=True, timeout=DP_TIMEOUT_S)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            raise AssertionError(f"the one-rank torchrun run exited {proc.returncode}")
        with open(out_json) as f:
            nccl = json.load(f)
        steps = nccl["steps"]
        if nccl["world"] != 1 or len(steps) != 2 * DP_EPOCH_STEPS:
            raise AssertionError(f"one-rank run: world {nccl['world']}, {len(steps)} steps")
        if cfg["kernels"] and any(s["launches"] != DEFAULT_STEP for s in steps):
            raise AssertionError(f"one-rank run launched {[s['launches'] for s in steps]}")
        got = steps[0]["metrics"]
        same = got["loss"] == first["loss"] and got["grad_norm"] == first["grad_norm"]
        print(f"one rank over NCCL (torchrun): first step loss {got['loss']!r} grad_norm "
              f"{got['grad_norm']!r}; phase 5's single process {first['loss']!r} "
              f"{first['grad_norm']!r}: {'bitwise equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError("the one-rank NCCL step differs from the single-process step")
        if not nccl["ckpt_equal"] or nccl["ckpt_step"] != DP_EPOCH_STEPS:
            raise AssertionError("checkpoint-0.pth (async) is not the state at its step")
        names, nccl_share, kernel_ms = _trace_stats(nccl["trace"])
        if cfg["kernels"] and names != list(FLASH_KERNEL_NAMES):
            raise AssertionError(f"the profile names {names} of {FLASH_KERNEL_NAMES}")
        unprofiled = [s["seconds"] * 1e3 for s in steps[DP_EPOCH_STEPS + 1:]]
        step_ms = float(np.median(unprofiled))
        print(f"one rank over NCCL: step ms " + " ".join(f"{s['seconds'] * 1e3:.1f}"
                                                         for s in steps)
              + f" (epoch 0 profiled); median of epoch 1's last {len(unprofiled)} "
              f"{step_ms:.1f} ms (an async save of epoch 0 in flight) vs phase 5's "
              f"{default_ms:.1f} ms ({step_ms / default_ms - 1:+.1%}); NCCL kernels "
              f"{nccl_share:.3%} of the profiled epoch's {kernel_ms:.1f} ms of kernel time; "
              f"trace names {', '.join(names) or 'no flash kernel'}; checkpoint-0.pth "
              f"(async) bitwise the state at step {nccl['ckpt_step']}")
        totals = {k: sum(s["launches"][k] for s in steps) for k in steps[0]["launches"]}

        # 2. two ranks sharing the card over gloo, each through main()
        res = _run_ranks({**cfg, "batch": DP_B, "backend": "gloo", "reference_remat": False},
                         tmp, 2, script)
    _check_ranks(res, 2, cfg["kernels"], "two ranks on one card",
                 "ranks sharing the card, gradients through the host: not a scaling number")
    print(f"data-parallel phase: {time.perf_counter() - t_phase:.1f} s")
    return totals


def _run_ranks(cfg, tmp, world, script, kind="ranks"):
    """The `world` rank processes of dp_rank_worker (`kind` "ranks"), of
    fsdp_rank_worker ("fsdp") or of vqvae_rank_worker ("vqvae"): spawned
    here with RANK, WORLD_SIZE and LOCAL_RANK 0 (gloo, one card), or by
    torchrun, one per card (NCCL).  Returns their rank{r}.json contents."""
    cfg_path = os.path.join(tmp, "ranks.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    worker = [script, "--dp-worker", kind, cfg_path, tmp]
    if cfg["backend"] == "gloo":
        # half the host's threads each, as torchrun would limit them
        env = {**os.environ, "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
               "OMP_NUM_THREADS": str(max((os.cpu_count() or 2) // world, 1))}
        procs = [subprocess.Popen([sys.executable, *worker], cwd=REPO_DIR,
                                  env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(world)]
    else:
        procs = [subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                   "--nproc_per_node", str(world), *worker], cwd=REPO_DIR,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        for log in logs:
            print(log[-4000:])
        raise AssertionError(f"the rank processes exited {[p.returncode for p in procs]}")
    res = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def _check_ranks(res, world, kernels, label, timing_note):
    """The ranks' runs against one process on the global batch: the first
    step's CE per target token within STEP_LOSS_RTOL and its gradients
    within STEP_GRAD_REL_L2, every rank's parameters equal rank 0's after
    every step, the same metrics on every rank, 36 / 36 / 36 / 2 launches
    per micro-batch, and the val pass within STEP_LOSS_RTOL."""
    for accum in ("1", "2"):
        runs = [r["runs"][accum] for r in res]
        expected = {k: v * int(accum) for k, v in DEFAULT_STEP.items()}
        for r, run in enumerate(runs):
            if run["world"] != world or len(run["steps"]) != DP_STEPS or not all(run["synced"]):
                raise AssertionError(f"accum {accum} rank {r}: world {run['world']}, "
                                     f"{len(run['steps'])} steps, parameters equal to rank "
                                     f"0's {run['synced']}")
            if kernels and any(s["launches"] != expected for s in run["steps"]):
                raise AssertionError(f"accum {accum} rank {r} launched "
                                     f"{[s['launches'] for s in run['steps']]}")
            if run["steps"][0]["metrics"] != runs[0]["steps"][0]["metrics"]:
                raise AssertionError(f"accum {accum}: rank {r}'s metrics differ from rank 0's")
        ref = res[0]["reference"][accum]
        tok_err = abs(ref["per_token"] - ref["ref_per_token"]) / abs(ref["ref_per_token"])
        print(f"{label} ({runs[0]['backend']}), {ref['rows'] // world // int(accum)} rows per "
              f"rank, accum {accum}: first step CE per target token {ref['per_token']:.6f} vs "
              f"{ref['ref_per_token']:.6f} for one process on the {ref['rows']}-row global "
              f"batch (rel {tok_err:.2e}; the training loss {ref['loss']:.6f} vs "
              f"{ref['ref_loss']:.6f}, grad_norm {ref['grad_norm']:.6f} vs "
              f"{ref['ref_grad_norm']:.6f}), gradient rel L2 {ref['grad_rel_l2']:.2e}; "
              f"parameters bitwise equal on all {world} ranks after each of {DP_STEPS} steps; "
              f"step ms by rank " + " / ".join(
                  " ".join(f"{s['seconds'] * 1e3:.1f}" for s in run["steps"]) for run in runs)
              + f" (the first of a run is its warm-up; {timing_note})")
        if not math.isfinite(ref["per_token"]) or tok_err > STEP_LOSS_RTOL \
                or ref["grad_rel_l2"] > STEP_GRAD_REL_L2:
            raise AssertionError(f"accum {accum}: the ranks' step disagrees with one "
                                 "process's step on the global batch")
    ev = res[0]["reference"]["eval"]
    ev_err = abs(ev["per_token"] - ev["ref_per_token"]) / abs(ev["ref_per_token"])
    print(f"{label}: val pass on the {ev['rows']}-row global batch: loss {ev['loss']:.6f} vs "
          f"{ev['ref_loss']:.6f} for one process, CE per target token rel {ev_err:.2e}; one "
          f"process's step at one rank's rows: {res[0]['reference']['single_ms']:.1f} ms")
    if any(r["runs"]["1"]["stats"] != res[0]["runs"]["1"]["stats"] for r in res) \
            or ev_err > STEP_LOSS_RTOL:
        raise AssertionError("the ranks' val pass disagrees with one process's eval")


# ---------------------------------------------------------------- phase 5f
# the FSDP ranks: FSDP_STEPS steps a run (the last step's peak is a steady
# step's: the first runs before Adam's moments exist); the first step's CE
# per target token against one process on the global batch (two fp32 sums
# of bf16 work in another order: 6e-8 in phase 5e)
FSDP_STEPS = 2
FSDP_CE_RTOL = 1e-6
FSDP_PERSISTENT_SHARE = 0.55   # an FSDP rank's parameters + moments over a DP rank's
# the two VQ-VAE ranks' step against one process's, both exact fp32: the same
# sums in another order.  The gradients' norm within VQ_GRAD_NORM_RTOL.  AdamW's
# first step moves each weight by lr * g / (|g| + eps): an element whose Adam
# RMS is at least ADAM_NOISE of its tensor's largest (its gradient is far from
# zero in both runs) moves the same, to VQ_WEIGHT_RTOL of the tensor's largest
# plus VQ_ADAM_SHARE of the LR; an element under it may step another way (a
# gradient within rounding of zero), by at most 2 lr.
VQ_GRAD_NORM_RTOL = 1e-5
VQ_WEIGHT_RTOL, VQ_ADAM_SHARE, ADAM_NOISE = 1e-5, 0.01, 1e-4
CARD_STEPS = 7                 # --cards N --fsdp: steps an epoch


def _memory(dev):
    """{"allocated": bytes now, "peak": the most since the last call} on a
    CUDA device (zeros on the CPU); restarts the peak."""
    if dev.type != "cuda":
        return {"allocated": 0, "peak": 0}
    torch.cuda.synchronize(dev)
    out = {"allocated": torch.cuda.memory_allocated(dev),
           "peak": torch.cuda.max_memory_allocated(dev)}
    torch.cuda.reset_peak_memory_stats(dev)
    return out


@contextlib.contextmanager
def _no_saves(skip: bool):
    """Within the block (when `skip`), the trainer's checkpoint saves return
    without gathering or writing anything, on every rank alike."""
    from egom2p_torch.core import checkpoint
    real = checkpoint.save_checkpoint
    if skip:
        checkpoint.save_checkpoint = lambda output_dir, tag, *a, **kw: \
            checkpoint.checkpoint_path(output_dir, tag)
    try:
        yield
    finally:
        checkpoint.save_checkpoint = real


def _persistent_bytes(optimizer):
    """This rank's parameters and Adam moments, in bytes (its pieces on a
    sharded model)."""
    params = sum(p.numel() * p.element_size() for p in optimizer.params)
    moments = sum(t.numel() * t.element_size() for st in optimizer.adamw.state.values()
                  for t in st.values() if torch.is_tensor(t) and t.dim() > 0)
    return params + moments


def fsdp_rank_worker(cfg, out_dir):
    """One of phase 5f's ranks (or of --cards N --fsdp's): rank RANK of
    WORLD_SIZE.  For each of cfg["modes"] ("dp", "fsdp") the trainer's
    main() with clipping off, cfg.get("steps", FSDP_STEPS) steps an epoch
    for cfg.get("epochs", 1) epochs (with cfg["reference"] FSDP trains a
    second epoch after an async checkpoint-0.pth; cfg["no_save"] writes no
    checkpoint): each step's launches, metrics, memory between steps and
    peak (on a CUDA device), the full
    parameters after every step against rank 0's (cfg["check_sync"]) and,
    with cfg["compare"], FSDP's full parameters after its first epoch
    against data parallelism's bitwise.  With cfg["reference"] rank 0 then
    leaves the group and holds the ranks' steps to one process's
    (_fsdp_reference).  Writes rank{RANK}.json to `out_dir`."""
    import datetime

    import torch.distributed as dist

    from egom2p_torch.cli import run_training
    from egom2p_torch.core import distributed

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if cfg["backend"] == "gloo":
        dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    else:
        distributed.init_distributed_mode(cfg["device"])
    dev = (torch.device("cuda", distributed.local_rank()) if cfg["device"] == "cuda"
           else torch.device("cpu"))
    # what the checks keep lives in host memory: a step's memory figures
    # are the trainer's alone
    made = _capture_optimizers(keep_grads=bool(cfg.get("reference")), to_host=True)
    runs, kept, b = {}, {}, cfg["batch"]
    for mode in cfg["modes"]:
        per_step, synced, snap = [], [], {}

        def full_params():
            return torch.cat([_full(made[-1], p, p).reshape(-1) for p in made[-1].params])

        def after():
            per_step[-1].update(_memory(dev))
            if cfg.get("check_sync"):
                flat = full_params()
                ref = flat.clone()
                dist.broadcast(ref, 0)
                synced.append(bool(torch.equal(ref, flat)))
                del flat, ref
                _memory(dev)  # the check's copies count in no step's peak

        def on_epoch(epoch, model, stats, mode=mode):
            if epoch or not (cfg.get("compare") or cfg.get("reference")):
                return
            flat = full_params().cpu()
            if mode == "dp":
                kept["dp_params"] = flat
            elif "dp_params" in kept:
                other = kept.pop("dp_params")
                snap["equal_dp"] = bool(torch.equal(flat, other))
                snap["max_diff_dp"] = float((flat - other).abs().max())
            if mode == "fsdp" and rank == 0 and cfg.get("reference"):
                kept["fsdp_params"] = flat

        sharded = mode == "fsdp"
        run_dir = os.path.join(out_dir, f"rank{rank}-{mode}")
        epochs = 2 if sharded and cfg.get("reference") else cfg.get("epochs", 1)
        args = run_training.get_args(_dp_argv(
            cfg, run_dir, b, b * world * cfg.get("steps", FSDP_STEPS), epochs,
            "--accum_steps", "1", "--eval_freq", "0", "--clip_grad", "0", "--async_save",
            "true", "--save_ckpt_freq", "1", *(["--fsdp", "true"] if sharded else []),
            *(["--use_act_checkpoint", "true"] if cfg.get("remat") else []),
            *(["--profile"] if cfg.get("profile") else [])))
        _memory(dev)  # the peak counts from here
        with _no_saves(cfg.get("no_save")):
            out = run_training.main(args, on_step=_counting_on_step(per_step, after),
                                    on_epoch=on_epoch)
        opt = made[-1]
        runs[mode] = {"steps": per_step, "synced": synced, "persistent": _persistent_bytes(opt),
                      "grad_bytes": sum(p.grad.numel() * p.grad.element_size()
                                        for p in opt.params if p.grad is not None),
                      "backend": dist.get_backend(), "world": dist.get_world_size(), **snap}
        if cfg.get("profile"):
            names, share, kernel_ms = _trace_stats(os.path.join(run_dir, "profile",
                                                                f"trace-rank{rank}.json"))
            runs[mode].update(collective_share=share, kernel_ms=kernel_ms)
        if sharded and cfg.get("reference") and rank == 0:
            kept["first_grads"] = opt.first_grads
            kept["ckpt"] = os.path.join(run_dir, "checkpoint-0.pth")
        opt.first_grads = None
        del out, opt
        made.clear()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    result = {"runs": runs}
    if rank == 0 and cfg.get("reference"):
        result["reference"] = _fsdp_reference(cfg, kept, runs, world, dev)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _fsdp_reference(cfg, kept, runs, world, dev):
    """One process (no group, no FSDP): the first step on the global batch of
    the ranks' first loader batches (CE per target token and gradients
    against the FSDP ranks'), then checkpoint-0.pth of the FSDP ranks
    loaded (every tensor against their gathered parameters, bitwise) and
    stepped on the global batch of their next loader batches, against
    their next step."""
    from egom2p_torch.cli import run_training
    from egom2p_torch.core import distributed
    from egom2p_torch.core.checkpoint import auto_load_model
    from egom2p_torch.core.optim import Optimizer
    from egom2p_torch.data.loader import batch_to_device
    from egom2p_torch.models.egom2p import create_model
    from egom2p_torch.train.egom2p_train import make_train_step

    n, b = cfg["tokens"], cfg["batch"]
    args = run_training.get_args(_dp_argv(cfg, "unused", b, b, 1))
    real_rank = distributed.rank
    batches = []
    try:
        iters = []
        for r in range(world):  # rank r's loader: its seed, its batches
            distributed.rank = lambda r=r: r
            iters.append(iter(run_training.setup_data(args)[0]))
        distributed.rank = real_rank
        for k in range(FSDP_STEPS + 1):
            parts = [next(it) for it in iters]
            batches.append({m: {key: np.concatenate([part[m][key] for part in parts]) for key in d}
                            for m, d in parts[0].items()})
        for it in iters:
            it.close()
    finally:
        distributed.rank = real_rank
    lr = 1e-4 * b * world / 256.0

    def model_at(ckpt=None):
        info = run_training.modality_info(args) if cfg["scaled"] else None
        model = create_model(cfg["model"], sorted(run_training.MODS4),
                             sorted(run_training.MODS4), device=dev, modality_info=info)
        model.init_random_(torch.Generator(device=dev).manual_seed(0))
        opt = Optimizer(model, [lr], clip_grad=None)
        shuffle = torch.Generator().manual_seed(1)  # the trainer's, seed + 1
        if ckpt:
            shuffle.set_state(auto_load_model(os.path.dirname(ckpt), model, opt)[0]
                              ["shuffle_rng"])
        return model, opt, shuffle

    out = {}
    steps = runs["fsdp"]["steps"]
    for label, batch, ckpt, got in (("first", batches[0], None, steps[0]["metrics"]),
                                    ("resumed", batches[FSDP_STEPS], kept["ckpt"],
                                     steps[FSDP_STEPS]["metrics"])):
        model, opt, shuffle = model_at(ckpt)
        if ckpt:
            flat = torch.cat([p.detach().reshape(-1) for p in opt.params]).cpu()
            out["ckpt_params_equal"] = bool(torch.equal(flat, kept.pop("fsdp_params")))
            del flat
        grads = {}
        real_step = opt.step

        def step_(grads=grads, opt=opt, real_step=real_step):
            grads["g"] = [p.grad.detach().clone() for p in opt.params]
            return real_step()

        opt.step = step_
        metrics = make_train_step(model, opt, n, n, "mod")(batch_to_device(batch, dev), shuffle)
        ref = {k: float(v) for k, v in metrics.items()}
        counts = _target_counts(batch)
        out[label] = {"rows": int(batch["tok_rgb"]["tensor"].shape[0]),
                      "per_token": _per_token(got, counts), "ref_per_token": _per_token(ref, counts),
                      "loss": got["loss"], "ref_loss": ref["loss"], "grad_norm": got["grad_norm"],
                      "ref_grad_norm": ref["grad_norm"]}
        if label == "first":
            num = math.sqrt(sum(((a.float().to(dev) - g.float()) ** 2).sum().item()
                                for a, g in zip(kept["first_grads"], grads["g"])))
            den = math.sqrt(sum((g.float() ** 2).sum().item() for g in grads["g"]))
            out[label]["grad_rel_l2"] = num / den
        del model, opt, grads, metrics
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _gib(nbytes) -> str:
    return f"{nbytes / 2 ** 30:.2f} GiB"


def fsdp_phase(dev, first, default_ms, cfg=None):
    """Phase 5f (docstring): the trainer with --fsdp true.  `first` is phase
    5's first-step metrics and `default_ms` its median step ms.  Returns
    the one-rank run's launch totals and its launches per step."""
    cfg = dict(DP_CONFIG if cfg is None else cfg)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    script = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            json.dump({**cfg, "fsdp": True, "profile": False}, f)
        # 1. one rank over NCCL with --fsdp true, launched as users launch it
        out_json = os.path.join(tmp, "nccl.json")
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", "1", script, "--dp-worker", "nccl",
                               cfg_path, out_json], cwd=REPO_DIR, capture_output=True,
                              text=True, timeout=DP_TIMEOUT_S)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            raise AssertionError(f"the one-rank FSDP torchrun run exited {proc.returncode}")
        with open(out_json) as f:
            nccl = json.load(f)
        steps = nccl["steps"]
        if nccl["world"] != 1 or len(steps) != 2 * DP_EPOCH_STEPS:
            raise AssertionError(f"one-rank FSDP run: world {nccl['world']}, {len(steps)} steps")
        if cfg["kernels"] and any(s["launches"] != DEFAULT_STEP for s in steps):
            raise AssertionError(f"one-rank FSDP run launched {[s['launches'] for s in steps]}")
        got = steps[0]["metrics"]
        same = got["loss"] == first["loss"] and got["grad_norm"] == first["grad_norm"]
        print(f"FSDP, one rank over NCCL (torchrun, --fsdp true): first step loss {got['loss']!r} "
              f"grad_norm {got['grad_norm']!r}; phase 5's single process {first['loss']!r} "
              f"{first['grad_norm']!r}: {'bitwise equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError("the one-rank FSDP step differs from the single-process step")
        if not nccl["ckpt_equal"] or nccl["ckpt_step"] != DP_EPOCH_STEPS:
            raise AssertionError("FSDP checkpoint-0.pth (async) is not the state at its step")
        step_ms = float(np.median([s["seconds"] * 1e3 for s in steps[1:]]))
        print(f"FSDP one rank: step ms " + " ".join(f"{s['seconds'] * 1e3:.1f}" for s in steps)
              + f"; median after the first {step_ms:.1f} ms vs phase 5's {default_ms:.1f} ms "
              f"({step_ms / default_ms - 1:+.1%}); between steps "
              f"{_gib(steps[-1]['allocated'])} allocated, a step's peak "
              f"{_gib(steps[-1]['peak'])}; checkpoint-0.pth (async) bitwise the gathered state "
              f"at step {nccl['ckpt_step']}")
        totals = {k: sum(s["launches"][k] for s in steps) for k in steps[0]["launches"]}

        # 2. two ranks sharing the card over gloo: data parallelism, then FSDP
        res = _run_ranks({**cfg, "batch": DP_B, "backend": "gloo", "modes": ["dp", "fsdp"],
                          "check_sync": True, "compare": True, "reference": True},
                         tmp, 2, script, "fsdp")
    _check_fsdp_ranks(res, 2, cfg["kernels"], "two ranks on one card")
    print(f"FSDP phase: {time.perf_counter() - t_phase:.1f} s")
    return totals, steps[0]["launches"]


def _check_fsdp_ranks(res, world, kernels, label, reference=True):
    """Every run of fsdp_rank_worker's ranks: FSDP_STEPS (or more) steps
    each with 36 / 36 / 36 / 2 launches, the same metrics on every rank,
    the gathered parameters equal on every rank after every step; the
    memory claims; with `reference`, the agreement with one process."""
    runs = {mode: [r["runs"][mode] for r in res] for mode in res[0]["runs"]}
    for mode, by_rank in runs.items():
        for r, run in enumerate(by_rank):
            if run["world"] != world or len(run["steps"]) < FSDP_STEPS \
                    or not all(run["synced"]):
                raise AssertionError(f"{label} {mode} rank {r}: world {run['world']}, "
                                     f"{len(run['steps'])} steps, equal to rank 0's "
                                     f"{run['synced']}")
            if kernels and any(s["launches"] != DEFAULT_STEP for s in run["steps"]):
                raise AssertionError(f"{label} {mode} rank {r} launched "
                                     f"{[s['launches'] for s in run['steps']]}")
            if [s["metrics"] for s in run["steps"]] != \
                    [s["metrics"] for s in by_rank[0]["steps"]]:
                raise AssertionError(f"{label} {mode}: rank {r}'s metrics differ from rank 0's")
        print(f"{label} ({by_rank[0]['backend']}), {mode}: step ms by rank " + " / ".join(
            " ".join(f"{s['seconds'] * 1e3:.1f}" for s in run["steps"]) for run in by_rank)
            + "; per rank: parameters + moments " + " / ".join(_gib(run["persistent"])
                                                                for run in by_rank)
            + ", gradients " + " / ".join(_gib(run["grad_bytes"]) for run in by_rank)
            + ", allocated between steps " + " / ".join(_gib(run["steps"][-1]["allocated"])
                                                        for run in by_rank)
            + ", step peaks " + " / ".join(" ".join(_gib(s["peak"]) for s in run["steps"])
                                            for run in by_rank[:1]) + " (rank 0)"
            + "".join(f", collectives {run['collective_share']:.2%} of {run['kernel_ms']:.1f} "
                      "ms of kernel time" for run in by_rank[:1] if "collective_share" in run))
    if "dp" in runs:
        dp, fs = runs["dp"][0], runs["fsdp"][0]
        share = fs["persistent"] / dp["persistent"]
        # the steady steps that both modes ran: from the second (the first
        # makes Adam's moments) to the shorter run's last
        n = min(len(fs["steps"]), len(dp["steps"]))
        peaks = [max(s["peak"] for s in run["steps"][1:n]) for run in (fs, dp)]
        print(f"{label}: an FSDP rank's parameters + moments are {share:.1%} of a data-parallel "
              f"rank's (limit {FSDP_PERSISTENT_SHARE:.0%}); the largest peak of step"
              f"{'s 2-' + str(n) if n > 2 else ' 2'} "
              f"{_gib(peaks[0])} against {_gib(peaks[1])}")
        measured = peaks[1] > 0  # zeros on the CPU: not measured
        if share > FSDP_PERSISTENT_SHARE or (measured and peaks[0] >= peaks[1]):
            raise AssertionError(f"{label}: FSDP does not hold less than data parallelism")
        if "equal_dp" in fs:
            print(f"{label}: FSDP's gathered parameters after {FSDP_STEPS} steps with clipping "
                  f"off {'bitwise equal to' if fs['equal_dp'] else 'DIFFER from'} data "
                  f"parallelism's on the same batches (largest difference "
                  f"{fs['max_diff_dp']:.3e})")
    if not reference:
        return
    ref = res[0]["reference"]
    first, resumed = ref["first"], ref["resumed"]
    errs = {k: abs(v["per_token"] - v["ref_per_token"]) / abs(v["ref_per_token"])
            for k, v in ref.items() if isinstance(v, dict)}
    print(f"{label}, FSDP: first step CE per target token {first['per_token']:.8f} vs "
          f"{first['ref_per_token']:.8f} for one process on the {first['rows']}-row global batch "
          f"(rel {errs['first']:.2e}; loss {first['loss']:.6f} vs {first['ref_loss']:.6f}, "
          f"grad_norm {first['grad_norm']:.6f} vs {first['ref_grad_norm']:.6f}), gradient rel "
          f"L2 {first['grad_rel_l2']:.2e}; checkpoint-0.pth of the FSDP ranks in one process "
          f"without FSDP: every tensor {'bitwise equal to' if ref['ckpt_params_equal'] else 'DIFFERENT from'} "
          f"their gathered parameters; the ranks' next step's CE per target token "
          f"{resumed['per_token']:.8f} vs {resumed['ref_per_token']:.8f} for one process "
          f"resumed from it (rel {errs['resumed']:.2e}), grad_norm {resumed['grad_norm']:.6f} "
          f"vs {resumed['ref_grad_norm']:.6f}")
    if not ref["ckpt_params_equal"] or max(errs.values()) > FSDP_CE_RTOL \
            or first["grad_rel_l2"] > STEP_GRAD_REL_L2:
        raise AssertionError(f"{label}: the FSDP ranks disagree with one process")


def vqvae_rank_worker(cfg, out_dir):
    """One of phase 5d's two VQ-VAE ranks: rank RANK of WORLD_SIZE over gloo
    on the shared card, run_training_vqvae.main at cfg["batch"] rows a
    rank; writes its step metrics and whether its weights and codebook
    equal rank 0's bitwise to rank{RANK}.json."""
    import datetime

    import torch.distributed as dist

    from egom2p_torch.cli import run_training_vqvae as rtv

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    steps = []
    res = rtv.main(cfg["argv"] + ["--batch_size", str(cfg["batch"])],
                   on_step=lambda s, m, sec: steps.append({"metrics": m, "seconds": sec}))
    flat = torch.cat([t.float().reshape(-1) for t in res["tokenizer"].net.state_dict().values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    synced = bool(torch.equal(ref, flat))
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"steps": steps, "synced": synced}, f)


def vqvae_ranks_check(dev, tmp, config, data, *extra):
    """The cam VQ-VAE trainer on two gloo ranks sharing the card, VQ_B / 2
    rows a rank, one step on VQ_B samples, against one process at VQ_B:
    the loss within FSDP_CE_RTOL, the codebook and the weights after the
    step, and the ranks' weights and codebook bitwise equal."""
    from egom2p_torch.cli import run_training_vqvae as rtv
    from egom2p_torch.core.checkpoint import load_pth

    t0 = time.perf_counter()
    data_path = os.path.join(tmp, "cam_ranks.npy")
    np.save(data_path, data[:VQ_B])
    argv = ["--config", config, "--data_path", data_path, "--device", dev.type, "--epochs", "1",
            "--eval_freq", "0", "--async_save", "false", "--seed", "0", "--print_freq", "1",
            *extra]
    ranks_dir, one_dir = os.path.join(tmp, "vq_ranks"), os.path.join(tmp, "vq_one")
    res = _run_ranks({"argv": argv + ["--output_dir", ranks_dir], "batch": VQ_B // 2,
                      "backend": "gloo"}, tmp, 2, os.path.abspath(__file__), "vqvae")
    one = []
    rtv.main(argv + ["--output_dir", one_dir, "--batch_size", str(VQ_B)],
             on_step=lambda s, m, sec: one.append(m))
    ranks_ckpt = load_pth(os.path.join(ranks_dir, "checkpoint-final.pth"))
    one_ckpt = load_pth(os.path.join(one_dir, "checkpoint-final.pth"))
    a, b = ranks_ckpt["model"], one_ckpt["model"]
    cb = {k: float((a[k].float() - b[k].float()).abs().max()) for k in a if "_codebook" in k}
    weights = _vq_weights_check(a, b, ranks_ckpt["optimizer"], one_ckpt["optimizer"])
    got, want = res[0]["steps"][0]["metrics"], one[0]
    errs = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
            for k in ("loss", "reconst_loss", "code_loss", "grad_norm")}
    print(f"cam VQ-VAE on two gloo ranks of {VQ_B // 2} rows against one process at {VQ_B}: "
          f"one step, loss {got['loss']:.8f} vs {want['loss']:.8f} (rel "
          + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
          + f"), codebook after the step: largest difference " + ", ".join(
              f"{k.rsplit('.', 1)[1]} {v:.2e}" for k, v in cb.items())
          + f"; weights: {weights['worst']:.2e} of each tensor's max at worst, outside Adam's "
          f"noise {weights['excess']:.2e} LR past {VQ_WEIGHT_RTOL} of it (limit "
          f"{VQ_ADAM_SHARE}), {weights['noisy']} of {weights['n']} elements within it, "
          f"{weights['noisy_steps']:.3f} LR off at worst (limit 2); usage "
          f"{got['codebook_usage']:.4f} vs {want['codebook_usage']:.4f}; ranks' weights and "
          f"codebook bitwise equal {[r['synced'] for r in res]}; "
          f"{time.perf_counter() - t0:.1f} s")
    loss_errs = [errs[k] for k in ("loss", "reconst_loss", "code_loss")]
    if max(loss_errs) > FSDP_CE_RTOL or errs["grad_norm"] > VQ_GRAD_NORM_RTOL \
            or weights["excess"] > VQ_ADAM_SHARE or weights["noisy_steps"] > 2.0 \
            or not all(r["synced"] for r in res) \
            or cb["quantize._codebook.embed"] > 1e-4 or cb["quantize._codebook.cluster_size"] > 1e-3 \
            or res[0]["steps"][0]["metrics"] != res[1]["steps"][0]["metrics"]:
        raise AssertionError("the two VQ-VAE ranks disagree with one process")


def _vq_weights_check(a, b, opt_a, opt_b):
    """The weights after the VQ-VAE's first step, `a` (the ranks') against
    `b` (one process's), with their optimizers' state dicts (every
    parameter in AdamW's state, in the model's parameter order): the
    largest difference over each tensor's max (`worst`); outside Adam's
    noise (VQ_WEIGHT_RTOL's comment) the largest excess past VQ_WEIGHT_RTOL
    of the tensor's max in units of the step's LR (`excess`); the elements
    within it (`noisy` of `n`) and their largest difference in LRs."""
    lr = float(opt_b["adamw"]["param_groups"][0]["lr"])
    order = [i for g in opt_b["adamw"]["param_groups"] for i in g["params"]]
    names = [k for k in b if "_codebook" not in k]
    if len(names) != len(order):
        raise AssertionError(f"{len(names)} weights, {len(order)} in AdamW's state")
    out = {"worst": 0.0, "excess": 0.0, "noisy": 0, "n": 0, "noisy_steps": 0.0}
    for name, i in zip(names, order):
        x, y = a[name].double(), b[name].double()
        scale = float(y.abs().max().clamp(min=1e-30))
        diff = (x - y).abs()
        rms = [o["adamw"]["state"][i]["exp_avg_sq"].double().sqrt() for o in (opt_a, opt_b)]
        noisy = (rms[0] < ADAM_NOISE * rms[0].max()) | (rms[1] < ADAM_NOISE * rms[1].max())
        excess = (diff - VQ_WEIGHT_RTOL * scale).clamp(min=0) / lr
        out["worst"] = max(out["worst"], float(diff.max()) / scale)
        out["excess"] = max(out["excess"], float(excess[~noisy].max()) if (~noisy).any() else 0.0)
        out["noisy_steps"] = max(out["noisy_steps"],
                                 float(diff[noisy].max()) / lr if noisy.any() else 0.0)
        out["noisy"] += int(noisy.sum())
        out["n"] += diff.numel()
    return out


def cards_check(world: int, fsdp: bool = False) -> int:
    """`python3 chip_smoke.py --cards N`: the trainer data-parallel over N
    cards of one host with NCCL, launched by torchrun, EgoM2P-base at B = 8
    per card, checked as phase 5e checks its two ranks (_check_ranks); the
    per-step times beside one process's step at B = 8 on one card.
    `--cards N --fsdp`: the trainer with and without --fsdp true over the N
    cards, EgoM2P-base at B = 8 per card and EgoM2P-large at B = 8 with
    remat, each step's tokens/s per card, the bytes each rank holds between
    steps and at a step's peak, and the collectives' share of a profiled
    run's kernel time (fsdp_cards)."""
    if torch.cuda.device_count() < world:
        print(f"chip_smoke --cards {world}: {torch.cuda.device_count()} CUDA devices",
              file=sys.stderr)
        return 2
    from egom2p_torch.ops import _build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.load()  # once, before the ranks load it
    t0 = time.perf_counter()
    if fsdp:
        return fsdp_cards(world)
    cfg = {**DP_CONFIG, "batch": B, "backend": "nccl", "reference_remat": True}
    with tempfile.TemporaryDirectory() as tmp:
        res = _run_ranks(cfg, tmp, world, os.path.abspath(__file__))
    _check_ranks(res, world, cfg["kernels"], f"{world} cards",
                 f"{world} cards of one host")
    print(f"data-parallel check on {world} cards: {time.perf_counter() - t0:.1f} s")
    return 0


def fsdp_cards(world: int) -> int:
    """--cards N --fsdp (cards_check)."""
    t0 = time.perf_counter()
    for model, remat in ((BASE_MODEL, False), (LARGE_MODEL, True)):
        # an epoch of CARD_STEPS profiled, then CARD_STEPS timed; no checkpoint
        cfg = {**DP_CONFIG, "model": model, "batch": B, "backend": "nccl", "remat": remat,
               "modes": ["dp", "fsdp"], "check_sync": True, "profile": True,
               "kernels": model == BASE_MODEL, "steps": CARD_STEPS, "epochs": 2,
               "no_save": True}
        with tempfile.TemporaryDirectory() as tmp:
            res = _run_ranks(cfg, tmp, world, os.path.abspath(__file__), "fsdp")
        label = f"{world} cards, {model} B = {B}{' remat' if remat else ''}"
        for mode in ("dp", "fsdp"):
            ms = [float(np.median([s["seconds"] for s in r["runs"][mode]["steps"][CARD_STEPS:]]))
                  * 1e3 for r in res]
            print(f"{label}, {mode}: step ms median by rank " + " / ".join(f"{m:.1f}" for m in ms)
                  + f"; {B * 4096 / max(ms) * 1e3:.0f} tokens/s per card")
        _check_fsdp_ranks(res, world, cfg["kernels"], label, reference=False)
    print(f"FSDP check on {world} cards: {time.perf_counter() - t0:.1f} s")
    return 0


def dp_worker(argv) -> int:
    """The phase 5d-5f worker processes: `--dp-worker nccl CONFIG OUT_JSON`
    under torchrun, `--dp-worker ranks|fsdp|vqvae CONFIG OUT_DIR` with RANK
    and WORLD_SIZE set (dp_rank_worker, fsdp_rank_worker,
    vqvae_rank_worker)."""
    kind, cfg_path, out = argv
    with open(cfg_path) as f:
        cfg = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets for every phase
    torch.backends.cudnn.allow_tf32 = False
    {"nccl": dp_nccl_worker, "ranks": dp_rank_worker, "fsdp": fsdp_rank_worker,
     "vqvae": vqvae_rank_worker}[kind](cfg, out)
    return 0


# ------------------------------------------------------------------ captions
# Phases 3d and 5g (docstring): the caption modality (30000 WordPiece ids, 256
# slots) in and out of EgoM2P-base, with a tokenizer.json the phase writes
# from these words (the reference's 30000-token file is not in the repo)
CAPTION_WORDS = """
a an the this that these those some many few one two three four five several other
man woman person people child hand hands left right arm finger fingers head face eye eyes
i you he she we they it my his her their our its me him them us
is are was were be been being has have had do does did can will would should could may
walk walks walking walked go goes going went come comes coming came turn turns turning
open opens opening opened close closes closing closed pick picks picking picked
put puts putting take takes taking took hold holds holding held place places placing
cut cuts cutting pour pours pouring poured wash washes washing washed wipe wipes wiping
stir stirs stirring mix mixes mixing cook cooks cooking cooked eat eats eating drink
drinks drinking look looks looking looked see sees seeing saw watch watches watching
read reads reading write writes writing type types typing press presses pressing push
pushes pushing pull pulls pulling move moves moving moved sit sits sitting stand stands
standing run runs running climb climbs climbing jump jumps ride rides riding drive
drives driving carry carries carrying throw throws throwing catch catches catching
kitchen table chair door window floor wall room house street road car bike bus train
cup mug glass bottle plate bowl pan pot knife fork spoon board sink tap water coffee tea
milk bread egg eggs rice pasta salt oil sugar onion tomato apple banana vegetable fruit
phone laptop screen keyboard mouse book paper pen box bag drawer shelf cabinet fridge
oven stove microwave towel soap sponge trash bin lid handle button switch light lamp
shoe shoes shirt jacket hat glove gloves ball dog cat tree grass park garden field sky
on in into onto at to from with without over under above below near next behind front
up down off out around through across along between inside outside top bottom side
and or but then while after before when where because so if not very slowly quickly
red blue green yellow white black small large big little long short new old full empty
"""
CAPTION_WORDS = CAPTION_WORDS.split()
CAPTION_MODS = ("caption", "tok_cam", "tok_depth", "tok_gaze", "tok_rgb")
CAUSAL_MODEL = "egom2p_base_12e_12d_swiglu_nobias_causal"
CAPTION_SLOTS = 256            # the empty caption target: S = 255 output slots
CAPTION_VOCAB = 30000
AR_PROFILE_TOKENS = (20, 30)   # the re-forwards a profiler traces: a stretch of steady steps
# flash64 launches: rgb2caption 12 encoder layers on the stacked 2B rows,
# then 12 cross-attentions a token (the causal self-attention is dense);
# caption2rgb's stacked step 12 encoder + 12 self + 12 cross
AR_ENCODER, AR_PER_TOKEN, CAPTION2RGB_STEP = 12, 12, 36
# the autoregressive cross-attention: stacked cond / uncond rows, S query
# rows against the bucketed encoder length behind 5120 rgb tokens and the
# caption's one visible slot (cond rows 5121 live keys, uncond rows 1)
AR_CROSS = (2 * B, CAPTION_SLOTS - 1, 5376, 5121, 1)
# one re-forward's CFG-mixed logits (30000 per row) with the kernels against
# the plain versions, fp32 compute: bf16 q/k/v in every attention through
# 12 + 12 blocks, as CONTEXT_ATOL
AR_LOGITS_ATOL = 2e-2
CAPTION_STEP = dict(DEFAULT_STEP, fwd=24, dq=24, dkv=24, ce_fwd=3)  # self-attention dense
CAPTION_TRAIN_STEPS, CAUSAL_STEPS = 6, 2  # 48 samples: cam or gaze without a target in all of them ~3e-4
CAPTION_ALPHAS = {"sampling_weights": [1.0, 1.0, 1.0, 1.0],
                  "alphas_mixture": {m: dict(_ALPHAS4, **({"keep": ["random", "all", "binary",
                                                                    "random"]}
                                                          if m == "caption" else {}))
                                     for m in CAPTION_MODS}}


def caption_model(dev):
    from egom2p_torch.models.egom2p import create_model
    model = create_model(BASE_MODEL, CAPTION_MODS, CAPTION_MODS, device=dev).eval()
    return model.init_random_(torch.Generator(device=dev).manual_seed(0))


def _caption_sample(tokens, n_slots=CAPTION_SLOTS):
    from egom2p_torch.data.modality_info import MODALITY_INFO
    from egom2p_torch.generate.sampler import (init_empty_target_modality,
                                               init_full_input_modality)
    sample = {"tok_rgb": {"tensor": tokens.reshape(tokens.shape[0], -1)}}
    init_full_input_modality(sample, MODALITY_INFO, "tok_rgb")
    init_empty_target_modality(sample, MODALITY_INFO, "caption", tokens.shape[0], n_slots)
    return sample


def ar_attention_bound_ms(b: int, heads: int, n: int, live_keys, hd: int = 64):
    """Bound of the forward kernel over the keys this call's rows keep
    (`live_keys` per batch row): two products per live score; q and o of
    every row and k, v of the live keys moved once."""
    keys = float(sum(live_keys))
    return bound_ms(2 * 2.0 * heads * n * keys * hd, 2.0 * heads * hd * (2 * b * n + 2 * keys))


def ar_cross_check(dev):
    """The forward kernel at the autoregressive cross-attention's shape
    against its plain version, beside its bound over the live keys and
    scaled_dot_product_attention on the same inputs and mask."""
    from egom2p_torch.ops.flash64 import flash64_attention, flash64_attention_reference

    b, n, m, live_c, live_u = AR_CROSS
    rng = np.random.default_rng(14)
    q, k, v = _fused_views(rng, n, m, dev, b=b)
    live = torch.tensor([live_c] * (b // 2) + [live_u] * (b // 2), device=dev)
    blocked = torch.arange(m, device=dev)[None] >= live[:, None]
    out = flash64_attention(q, k, v, blocked)
    torch.cuda.synchronize()
    ref = flash64_attention_reference(q, k, v, blocked)
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
    ms = _cuda_time_ms(lambda: flash64_attention(q, k, v, blocked), 20)
    plain_ms = _cuda_time_ms(lambda: flash64_attention_reference(q, k, v, blocked), 3, 1)
    lib_ms, _, _ = _sdpa_ms(*(_split_heads(t, HEADS) for t in (q, k, v)), blocked)
    bound, bound_by = ar_attention_bound_ms(b, HEADS, n, live.tolist())
    print(f"flash64 autoregressive cross-attention ({b}, {n}, {m}), {live_c} / {live_u} live "
          f"keys (cond / uncond rows): max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  scaled_dot_product_attention {lib_ms:.4f} ms  bound "
          f"{bound:.4f} ms ({bound_by}, {bound / ms:.0%})")
    return {"shape": [b, n, m], "live_keys": [live_c, live_u], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms}


def ar_logits_check(model, sampler, tokens, caption, n_gen):
    """One re-forward of the CFG step (the stacked cond / uncond rows) over
    a generated caption (`n_gen` slots written), in fp32, with the kernels
    against the plain versions: the CFG-mixed logits of the row that chose
    the last slot, for every batch row."""
    import egom2p_torch.ops.flash64 as f64
    from egom2p_torch.generate.sampler import _bucket
    from egom2p_torch.ops.attention import inference_attention

    md = _caption_sample(tokens.cpu())
    md["tok_rgb"]["tensor"] = md["tok_rgb"]["tensor"].numpy()
    stacked = sampler._stack_dicts(md, sampler._make_uncond(md, ["tok_rgb"]))
    dev_md = sampler._to_device(stacked)
    n_enc = _bucket(sampler._num_enc_tokens(stacked))
    b = tokens.shape[0]
    out_ids = torch.as_tensor(np.concatenate([caption[:, 1:CAPTION_SLOTS]] * 2),
                              device=tokens.device).long()
    row = max(n_gen - 2, 0)
    _, emb, _ = model.decoder_embeddings["caption"].forward_embed(dev_md["caption"],
                                                                  torch.bfloat16)
    y_emb = emb[:, 1:CAPTION_SLOTS]
    kernel = f64.flash64_attention

    def logits():
        with torch.inference_mode(), inference_attention():
            ctx, mask = model.forward_enc_context(dev_md, n_enc, torch.float32)
            y = model.forward_dec_autoregressive_hidden("caption", out_ids, y_emb, ctx, mask,
                                                        torch.float32)
            last = model.forward_mod_logits("caption", y[:, row])
            return last[b:] + (last[:b] - last[b:]) * 2.0

    with_kernel = logits()
    f64.flash64_attention = f64.flash64_attention_reference
    try:
        plain = logits()
    finally:
        f64.flash64_attention = kernel
    err = (with_kernel - plain).abs().max().item()
    same = (with_kernel.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"rgb2caption re-forward at slot {row + 1}, fp32, kernels vs plain versions: CFG "
          f"logits max_abs_err {err:.3e} (|logits| max {plain.abs().max().item():.3f}), argmax "
          f"equal in {same:.0%} of the rows")
    if not torch.isfinite(with_kernel).all() or err > AR_LOGITS_ATOL:
        raise AssertionError(f"rgb2caption logits disagree with the plain versions: {err}")
    return err


def caption_serve_phase(dev, served, tmp):
    """Phase 3d (docstring): rgb2caption and caption2rgb at full width.
    Returns {"rgb2caption": launches, "caption2rgb": launches, "ar_cross": row}."""
    from egom2p_torch.cli.eval_common import roar_schedule
    from egom2p_torch.data.modality_info import MODALITY_INFO
    from egom2p_torch.generate.sampler import GenerationSampler, init_full_input_modality
    from egom2p_torch.generate.schedules import build_chained_generation_schedules
    from egom2p_torch.ops.flash64 import flash64_attention
    from egom2p_torch.utils.text_tokenizer import load_text_tokenizer, write_wordpiece_json

    t_phase = time.perf_counter()
    tok = load_text_tokenizer(write_wordpiece_json(os.path.join(tmp, "tokenizer.json"),
                                                   CAPTION_WORDS))
    model = caption_model(dev)
    sampler = GenerationSampler(model)
    print(f"caption model: EgoM2P-base with {', '.join(CAPTION_MODS)} in and out, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params; tokenizer.json "
          f"of {tok.get_vocab_size()} ids")
    rgb = served["rgb"]
    schedule = build_chained_generation_schedules(
        ["tok_rgb"], ["caption"], [CAPTION_SLOTS], ["autoregressive"], [0], ["linear"],
        [0.01], ["constant"], [2.0], ["constant"])
    finite = []
    hooks = [m.register_forward_hook(lambda _m, _i, out: finite.append(torch.isfinite(out).all()))
             for m in (model.encoder_norm, model.decoder_norm)]

    def rgb2caption(seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler.generate(_caption_sample(rgb), schedule, top_p=0.8, seed=seed)
        torch.cuda.synchronize()
        return out["caption"], time.perf_counter() - t0

    runs = []  # the phases before warmed the kernels and the allocator up
    for rep in range(2):
        finite.clear()
        flash64_attention.launches = 0
        cap, seconds = rgb2caption(rep)
        launches = flash64_attention.launches
        filled = ~cap["input_mask"]
        n_gen = int(filled[0].sum()) - 1  # slot 0 held the given [S_1]
        steps = n_gen - 1                 # the first output slot is given
        ids = cap["tensor"][filled]
        print(f"rgb2caption B={B} run {rep}: {seconds * 1e3:.1f} ms, {n_gen} slots "
              f"({steps} decoder re-forwards), {seconds * 1e3 / steps:.2f} ms per generated "
              f"token, {B * steps / seconds:.0f} tokens/s, flash64 launches {launches}; "
              f"caption 0's first ids {cap['tensor'][0, 1:9].tolist()}")
        if launches != AR_ENCODER + AR_PER_TOKEN * steps:
            raise AssertionError(f"rgb2caption: {launches} flash64 launches for {steps} tokens, "
                                 f"expected {AR_ENCODER} + {AR_PER_TOKEN} a token")
        if (filled.sum(1) != filled[0].sum()).any() or ids.min() < 0 or \
                ids.max() >= CAPTION_VOCAB or not all(bool(f) for f in finite):
            raise AssertionError("rgb2caption: ragged rows, ids outside [0, 30000) or "
                                 "non-finite hidden states")
        runs.append((seconds, steps, launches))
    for h in hooks:
        h.remove()
    ms_tok = float(np.median([s / n for s, n, _ in runs])) * 1e3

    # a profiled stretch of steady re-forwards (the profiler's own overhead
    # stretches them; the idle share is against the unprofiled ms a token);
    # the run ends with the stretch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    real = model.forward_dec_autoregressive_hidden
    calls, wall = {"n": 0}, {}

    class Traced(Exception):
        pass

    def traced(*a, **kw):
        first, last = AR_PROFILE_TOKENS
        if calls["n"] in (first, last):
            torch.cuda.synchronize()
            wall[calls["n"]] = time.perf_counter()
            (prof.start if calls["n"] == first else prof.stop)()
            if calls["n"] == last:
                raise Traced
        calls["n"] += 1
        return real(*a, **kw)

    model.forward_dec_autoregressive_hidden = traced
    try:
        rgb2caption(7)
    except Traced:
        pass
    finally:
        model.forward_dec_autoregressive_hidden = real
    n_traced = AR_PROFILE_TOKENS[1] - AR_PROFILE_TOKENS[0]
    if len(wall) == 2:
        _device_breakdown(prof, f"{n_traced} caption tokens",
                          (wall[AR_PROFILE_TOKENS[1]] - wall[AR_PROFILE_TOKENS[0]]) * 1e3,
                          n_traced * ms_tok)
    else:
        print(f"rgb2caption profile: the run stopped after {calls['n']} re-forwards, before "
              "the traced stretch; idle share not measured")
    ar_row = ar_cross_check(dev)
    ar_row["logits_err"] = ar_logits_check(model, sampler, rgb, cap["tensor"],
                                           int((~cap["input_mask"][0]).sum()) - 1)

    # caption2rgb: ROAR over 5120 rgb tokens on a seeded caption, CFG 2.0 on
    # the caption (the stacked 2B-row step)
    rng = np.random.default_rng(3)
    eos = tok.token_to_id("[EOS]")
    caption = np.zeros((B, 2 * (CAPTION_SLOTS + 1)), np.int32)
    for i in range(B):
        ids = tok.encode(" ".join(CAPTION_WORDS[j] for j in rng.integers(
            0, len(CAPTION_WORDS), 24)).capitalize() + ".").ids[:60]
        caption[i, :len(ids)], caption[i, len(ids)] = ids, eos
    cond = {"caption": {"tensor": caption}}
    init_full_input_modality(cond, MODALITY_INFO, "caption", eos_id=eos)
    schedule = roar_schedule("caption", "tok_rgb")

    def caption2rgb(seed):
        from egom2p_torch.generate.sampler import init_empty_target_modality
        md = {"caption": {k: v.copy() for k, v in cond["caption"].items()}}
        init_empty_target_modality(md, MODALITY_INFO, "tok_rgb", B,
                                   MODALITY_INFO["tok_rgb"]["max_tokens"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler.generate(md, schedule, top_p=0.8, seed=seed)
        torch.cuda.synchronize()
        return out["tok_rgb"], time.perf_counter() - t0

    caption2rgb(100)
    times = []
    for rep in range(3):
        flash64_attention.launches = 0
        out, seconds = caption2rgb(rep)
        c2r = flash64_attention.launches
        times.append(seconds)
        if c2r != CAPTION2RGB_STEP * len(schedule) or not out["target_mask"].all() or \
                np.asarray(out["tensor"]).min() < 0 or np.asarray(out["tensor"]).max() >= 64000:
            raise AssertionError(f"caption2rgb: {c2r} flash64 launches (expected "
                                 f"{CAPTION2RGB_STEP} a step), or rgb tokens missing or "
                                 "outside [0, 64000)")
    c2r_ms = float(np.median(times)) * 1e3
    print(f"caption2rgb B={B} (ROAR {len(schedule)} steps, CFG 2.0 on the caption, stacked "
          f"2B rows): generate " + " ".join(f"{t * 1e3:.1f}" for t in times) + f" ms, median "
          f"{c2r_ms:.1f} ms, {B / c2r_ms * 1e3:.2f} clips/s, flash64 launches "
          f"{c2r // len(schedule)} a step")
    del model, sampler
    torch.cuda.empty_cache()
    print(f"caption serving phase: {time.perf_counter() - t_phase:.1f} s")
    return {"rgb2caption": runs[-1][2], "caption2rgb": c2r, "ar_cross": ar_row}


def caption_train_phase(dev):
    """Phase 5g (docstring): EgoM2P-base with captions on shards through the
    trainer, then the causal registry model.  Returns the launch totals
    {"caption": ..., "causal": ...}."""
    from egom2p_torch.cli import run_training
    from egom2p_torch.data.loader import batch_to_device
    from egom2p_torch.utils.text_tokenizer import write_wordpiece_json

    t_phase = time.perf_counter()
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        pattern, _ = write_shards(tmp, "captioned", 2, SHARD_SAMPLES, 20, captions=True)
        val_pattern, _ = write_shards(tmp, "held_out", 1, B, 21, captions=True)
        tok_path = write_wordpiece_json(os.path.join(tmp, "tokenizer.json"), CAPTION_WORDS)
        alphas = os.path.join(tmp, "alphas.json")
        with open(alphas, "w") as f:
            json.dump(CAPTION_ALPHAS, f)
        dataset = dict(DATA_MOD4["train"]["datasets"]["example"], data_path=pattern,
                       alphas_config=alphas, wds_n_repeats=1,
                       in_domains="-".join(CAPTION_MODS), out_domains="-".join(CAPTION_MODS))
        data_config = os.path.join(tmp, "data_caption.json")
        with open(data_config, "w") as f:
            json.dump({"train": {"datasets": {"captioned": dataset}, "weights": [1.0]},
                       "val": {"datasets": {"captioned": {"data_path": val_pattern}}}}, f)
        for label, model_name, steps, eval_iters in (
                ("EgoM2P-base with captions", BASE_MODEL, CAPTION_TRAIN_STEPS, 1),
                ("EgoM2P-base causal with captions", CAUSAL_MODEL, CAUSAL_STEPS, 0)):
            out_dir = os.path.join(tmp, model_name)
            argv = [*MAIN_MOD4_ARGS, "--model", model_name, "--data_config", data_config,
                    "--text_tokenizer_path", tok_path, "--num_workers", str(SHARD_WORKERS),
                    "--lr_schedule", "constant", "--epochs", "1",
                    "--epoch_size", str(B * steps), "--eval_iters", str(eval_iters),
                    "--eval_freq", "1" if eval_iters else "0", "--seed", "0",
                    "--output_dir", out_dir, "--print_freq", "1", "--save_ckpt_freq", "2"]
            args = run_training.get_args(argv)
            per_step = []
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_counts()
            last = _counts()

            def on_step(step, metrics, seconds):
                now = _counts()
                per_step.append(({k: now[k] - last[k] for k in now}, metrics, seconds))
                last.update(now)

            out = run_training.main(args, on_step=on_step)
            peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            totals[model_name] = _counts()
            if len(per_step) != steps:
                raise AssertionError(f"{label}: {len(per_step)} steps ran")
            for step, (launches, metrics, _) in enumerate(per_step):
                if launches != CAPTION_STEP:
                    raise AssertionError(f"{label} step {step} launched {launches}, expected "
                                         f"{CAPTION_STEP}")
                if not all(math.isfinite(v) for v in metrics.values()):
                    raise AssertionError(f"{label} step {step}: non-finite metrics {metrics}")
            vocab = {m: v for m, (_, _, v) in SHARD_MODS.items()}
            # the causal run is for correctness only: its 2 steps may hold
            # no target of some modality
            for mod, v in (dict(vocab, caption=CAPTION_VOCAB).items()
                           if model_name == BASE_MODEL else ()):
                losses = [m[f"loss_{mod}"] for _, m, _ in per_step if m[f"loss_{mod}"] != 0.0]
                if not losses or abs(losses[0] - math.log(v)) > 0.5:
                    raise AssertionError(f"{label} {mod}: first losses {losses[:1]}, ln {v} = "
                                         f"{math.log(v):.3f}")
            step_ms = float(np.median([s for _, _, s in per_step[1:]])) * 1e3
            print(f"{label} (B={B}, {SHARD_WORKERS} workers, 2048 + 2048 tokens): train steps "
                  "ms " + " ".join(f"{s * 1e3:.1f}" for _, _, s in per_step) + f"; median "
                  f"{step_ms:.1f} ms, {B * 4096 / step_ms * 1e3:.0f} tokens/s, peak memory "
                  f"{peak_gib:.2f} GiB; first losses " + ", ".join(
                      f"{k[5:]} {v:.3f}" for k, v in per_step[0][1].items()
                      if k.startswith("loss_")) + f"; launches per step {CAPTION_STEP}")
            model, optimizer = out.pop("model"), out.pop("optimizer")
            del out
            if model_name == BASE_MODEL:
                init = caption_model(dev)
                init.init_random_(torch.Generator(device=dev).manual_seed(args.seed))
                moved = {k: not torch.equal(a, b) for (k, a), b in
                         zip(model.named_parameters(), init.parameters())}
                del init
                if not all(moved.values()):
                    raise AssertionError(f"{label}: did not move: "
                                         f"{[k for k, v in moved.items() if not v][:8]}")
                print(f"{label}: all {len(moved)} parameter tensors moved, the caption's "
                      "token and modality embeddings among them")
                loader, _ = run_training.setup_data(args)
                it = iter(loader)
                data = batch_to_device(next(it), dev)
                it.close()
                profile_step(model, optimizer, data, step_ms)
                step_check(model, data, CAPTION_STEP, _plain_versions("default"))
                del data
            del model, optimizer
            torch.cuda.empty_cache()
    print(f"caption training phase: {time.perf_counter() - t_phase:.1f} s")
    return totals


# --------------------------------------------- image-domain tokenizers (slice 15)
MULTI_WEIGHTS = [2.0, 1.0]     # conditions {tok_rgb} and {tok_cam}
MULTI_LAUNCHES = 3 * (12 + 12 * 2)   # one stacked encoder + decoder self / cross a step
MULTI_GREEDY_SHARE = 5e-3      # greedy tokens the bf16 kernel may move against its plain version
VIDEO_ARGS = dict(frames=16, size=256, tubelet=2, patch=16)   # the CLI's video defaults
VIDEO_CLIPS, VIDEO_CLIP_FRAMES = 24, 20   # 3 steps of 8; windows of 16 in 20 frames
VIDEO_STEP = dict(NO_LAUNCHES, fwd=24, dq=24, dkv=24)         # 12 + 12 blocks
VIDEO_EVAL_CLIPS = 2
FEATURE_IMAGES = 192           # 3 steps at the config's batch of 64
TEACHER_B = 8
# bf16 tower: kernels against plain, relative L2 of the map (1.26e-2 seen on
# ImageBind's 32 blocks, NVIDIA H100 80GB HBM3, 700 W)
TEACHER_REL_L2 = 3e-2
SAM_BATCH, SAM_SLOTS = 8, 64
# cfgs/vqvae/clip_b16.yaml, for a machine without PyYAML
CLIP_B16_CONFIG = {
    "run_name": "auto", "domain": "CLIP-B16", "teacher_ckpt": None, "teacher_dtype": "bf16",
    "vq_dim": 768, "vq_depth": 12, "vq_heads": 12, "codebook_size": 8192, "latent_dim": 32,
    "norm_codes": True, "quantizer_type": "lucid", "code_replacement_policy": "batch_random",
    "commitment_weight": 1.0, "quantizer_ema_decay": 0.99, "kmeans_init": False,
    "loss_fn": "mse", "codebook_weight": 1.0, "dtype": "fp32", "epochs": 100, "opt": "adamw",
    "opt_betas": [0.9, 0.99], "blr": 0.000025, "warmup_lr": 0.000001, "min_lr": 0.0,
    "warmup_epochs": 5, "batch_size": 64, "clip_grad": 1.0, "save_ckpt_freq": 10,
    "output_dir": "output/vqvae_clip_b16", "log_wandb": False}


def _multi_inputs(rgb, cam):
    """(uncond, conds) of multi-condition rgb2depth: every modality with
    the conditioning emptied; the conditions {tok_rgb} and {tok_cam}."""
    from egom2p_torch.data.modality_info import MODALITY_INFO
    from egom2p_torch.generate.sampler import (empty_img_modality, init_empty_target_modality,
                                               init_full_input_modality)
    full = {"tok_rgb": {"tensor": rgb.copy()}, "tok_cam": {"tensor": cam.copy()}}
    for m in full:
        init_full_input_modality(full, MODALITY_INFO, m)
    init_empty_target_modality(full, MODALITY_INFO, "tok_depth", rgb.shape[0],
                               MODALITY_INFO["tok_depth"]["max_tokens"])
    uncond = {m: {k: np.array(v) for k, v in d.items()} for m, d in full.items()}
    for m in ("tok_rgb", "tok_cam"):
        empty_img_modality(uncond[m])
    return uncond, [{"tok_rgb": full["tok_rgb"]}, {"tok_cam": full["tok_cam"]}]


def multi_guided_phase(dev, served):
    """Phase 3e (docstring): multi-condition rgb2depth and the rgb@224
    encoder context.  Returns {"launches": per generate, "rgb224_err": x}."""
    import egom2p_torch.ops.flash64 as f64
    from egom2p_torch.cli.eval_common import roar_schedule

    model, sampler = served["model"], served["sampler"]
    rgb = served["rgb"].reshape(served["rgb"].shape[0], -1).cpu().numpy().astype(np.int32)
    b = rgb.shape[0]
    cam = np.random.default_rng(15).integers(0, 256, (b, 30)).astype(np.int32)

    def schedule(temperature, steps=3):
        out = roar_schedule("tok_rgb", "tok_depth", temperature=temperature)[:steps]
        return [dict(s, cfg_scale=MULTI_WEIGHTS) for s in out]

    def run(sched, seed):
        uncond, conds = _multi_inputs(rgb, cam)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler.generate_multi_guided(uncond, conds, sched, top_p=0.8, seed=seed)
        torch.cuda.synchronize()
        return out["tok_depth"], time.perf_counter() - t0

    run(schedule(0.01), 100)  # warm-up
    times = []
    for rep in range(3):
        f64.flash64_attention.launches = 0
        depth, seconds = run(schedule(0.01), rep)
        launches = f64.flash64_attention.launches
        times.append(seconds)
        print(f"multi-condition rgb2depth run {rep} (B={b}, conditions tok_rgb / tok_cam at "
              f"{MULTI_WEIGHTS}): generate {seconds * 1e3:.1f} ms, {b / seconds:.3f} clips/s, "
              f"flash64 launches {launches}")
        if launches != MULTI_LAUNCHES:
            raise AssertionError(f"multi-guided generate: {launches} launches, expected "
                                 f"{MULTI_LAUNCHES}")
        if not depth["target_mask"].all() or depth["tensor"].min() < 0 \
                or depth["tensor"].max() >= 64000:
            raise AssertionError("multi-guided generate: a position unfilled or out of range")
    gen_ms = float(np.median(times)) * 1e3
    print(f"multi-condition rgb2depth median: {gen_ms:.1f} ms, {b / gen_ms * 1e3:.3f} clips/s")
    # greedy first step, the kernel against its plain version
    kernel = f64.flash64_attention
    greedy_k, _ = run(schedule(0.0, 1), 7)
    f64.flash64_attention = f64.flash64_attention_reference
    try:
        greedy_p, _ = run(schedule(0.0, 1), 7)
    finally:
        f64.flash64_attention = kernel
    filled = ~greedy_p["input_mask"]
    if not np.array_equal(filled, ~greedy_k["input_mask"]):
        raise AssertionError("greedy multi-guided: the positions filled differ")
    unequal = int((greedy_k["tensor"][filled] != greedy_p["tensor"][filled]).sum())
    share = unequal / max(int(filled.sum()), 1)
    print(f"greedy multi-guided step, kernels vs plain: {unequal} of {int(filled.sum())} "
          f"tokens differ ({share:.2e}; tolerance {MULTI_GREEDY_SHARE:g})")
    if share > MULTI_GREEDY_SHARE:
        raise AssertionError("greedy multi-guided tokens: the kernel disagrees with plain")
    return {"launches": launches, "generate_ms": gen_ms,
            "rgb224_err": rgb224_context_check(dev, served["rgb"])}


def rgb224_context_check(dev, rgb_tokens):
    """The encoder context of EgoM2P-base over rgb@224 pixels (196 patches)
    and the rgb tokens, fp32, the kernel against its plain version."""
    import egom2p_torch.ops.flash64 as f64
    from egom2p_torch.models.egom2p import create_model
    from egom2p_torch.ops.attention import inference_attention

    model = create_model(BASE_MODEL, ("rgb@224", "tok_rgb"), ("tok_depth",), device=dev).eval()
    model.init_random_(torch.Generator(device=dev).manual_seed(4))
    b = rgb_tokens.shape[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    md = {"rgb@224": {"tensor": torch.rand((b, 224, 224, 3), generator=gen, device=dev) * 2 - 1,
                      "input_mask": torch.zeros((b, 196), dtype=torch.bool, device=dev)},
          "tok_rgb": {"tensor": rgb_tokens.reshape(b, -1),
                      "input_mask": torch.zeros((b, rgb_tokens[0].numel()), dtype=torch.bool,
                                                device=dev)}}
    n = 196 + rgb_tokens[0].numel()
    n = -(-n // 256) * 256
    kernel = f64.flash64_attention
    with torch.inference_mode(), inference_attention():
        f64.flash64_attention.launches = 0
        ctx_k, _ = model.forward_enc_context(md, n, torch.float32)
        launches = f64.flash64_attention.launches
        f64.flash64_attention = f64.flash64_attention_reference
        try:
            ctx_p, _ = model.forward_enc_context(md, n, torch.float32)
        finally:
            f64.flash64_attention = kernel
    err = (ctx_k - ctx_p).abs().max().item()
    print(f"rgb@224 + tok_rgb encoder context (B={b}, {n} tokens), fp32, kernel vs plain: "
          f"max_abs_err {err:.3e} (tolerance {CONTEXT_ATOL:g}), {launches} flash64 launches")
    if not torch.isfinite(ctx_k).all() or err > CONTEXT_ATOL \
            or launches != model.config.encoder_depth:
        raise AssertionError("rgb@224 encoder context disagrees with plain attention")
    return err


def write_random_metric_weights(directory):
    """RANDOM (seeded) InceptionV3 and LPIPS-VGG weight files at the
    published shapes in `directory`: the metrics' code runs on the card; the
    numbers they give mean nothing (no published weights are in the repo)."""
    from egom2p_torch.core import inception_v3, vgg_features
    rng = np.random.default_rng(21)
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, "lpips_vgg.npz"), **vgg_features.random_weights(rng))
    np.savez(os.path.join(directory, "inception_v3.npz"),
             **inception_v3.random_weights(rng, n_classes=1008))
    print(f"RANDOM seeded LPIPS-VGG and InceptionV3 (1008 classes) weights written to "
          f"{directory}: the LPIPS / FID / IS numbers below are of random networks")


def video_vqvae_flops_per_sample(frames=16, size=256, tubelet=2, patch=16, dim=768, depth=12,
                                 channels=3, latent=32, codes=256):
    """Model FLOPs of one video VQ-VAE training clip: the tubelet patchify
    and the unpatchify products, 2 x depth blocks over the (frames / t) x
    (size / p)^2 tokens (qkv, proj, MLP 4x; QK^T and AV), the quant
    projections and the codebook lookup; forward times 3."""
    n = (frames // tubelet) * (size // patch) ** 2
    pix = tubelet * patch * patch * channels
    per_token = 2 * depth * (24 * dim ** 2 + 4 * n * dim) + 2 * 2 * pix * dim
    per_token += 4 * dim * latent + 2 * codes * latent
    return 3 * n * per_token


def _write_video_clips(root, n, frames, size, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        np.save(os.path.join(root, f"clip{i:03d}.npy"),
                rng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8))
    return root


def video_vqvae_phase(dev, tmp, train_rows):
    """Phase 5h (docstring): the rgb video VQ-VAE at the CLI's video
    defaults.  Returns {"launches": per step, "step_ms": x, ...}."""
    from egom2p_torch.cli import run_training_vqvae
    from egom2p_torch.train.vqvae_train import make_vqvae_train_step

    va = VIDEO_ARGS
    clips = _write_video_clips(os.path.join(tmp, "video_clips"), VIDEO_CLIPS, VIDEO_CLIP_FRAMES,
                               va["size"], 16)
    tok_dir = _write_video_clips(os.path.join(tmp, "video_tok"), 2, va["frames"], va["size"], 17)
    ckpt_dir = os.path.join(tmp, "metric_weights")
    write_random_metric_weights(ckpt_dir)
    out = os.path.join(tmp, "video_vqvae")
    argv = ["--domain", "rgb", "--data_path", clips, "--use_npy", "--num_frames",
            str(va["frames"]), "--input_size", str(va["size"]), "--tubelet_size",
            str(va["tubelet"]), "--patch_size", str(va["patch"]), "--batch_size", str(B),
            "--epochs", "1", "--warmup_epochs", "0", "--eval_freq", "1",
            "--num_eval_metrics_samples", str(VIDEO_EVAL_CLIPS), "--output_dir", out,
            "--async_save", "false", "--print_freq", "1", "--device", "cuda"]
    per_step, seconds = [], []

    def on_step(step, metrics, secs):
        per_step.append(_counts())
        seconds.append(secs)

    _reset_counts()
    t0 = time.perf_counter()
    with _env(EGOM2P_CKPT_DIR=ckpt_dir):
        res = run_training_vqvae.main(argv, on_step=on_step)
    run_s = time.perf_counter() - t0
    prev = {k: 0 for k in per_step[0]}
    for i, counts in enumerate(per_step):
        step = {k: counts[k] - prev[k] for k in counts}
        prev = counts
        if step != VIDEO_STEP:
            raise AssertionError(f"video VQ-VAE step {i}: launches {step}, expected {VIDEO_STEP}")
    metrics = res["metrics"]
    if not all(math.isfinite(m["loss"]) for m in metrics):
        raise AssertionError(f"video VQ-VAE: non-finite losses {metrics}")
    log = [json.loads(line) for line in open(os.path.join(out, "log.txt"))]
    wanted = {"eval_mse", "eval_psnr", "eval_lpips", "eval_fid", "eval_inception_score",
              "eval_codebook_usage"} | ({"eval_ms_ssim"} if va["size"] >= 176 else set())
    if not wanted <= set(log[-1]) or not all(math.isfinite(log[-1][k]) for k in wanted):
        raise AssertionError(f"video VQ-VAE eval: {log[-1]}")
    step_ms = float(np.median(seconds[1:])) * 1e3
    flops = video_vqvae_flops_per_sample(va["frames"], va["size"], va["tubelet"], va["patch"]) * B
    print(f"video VQ-VAE (rgb, {va['frames']} x {va['size']}^2, tubelet {va['tubelet']}, patch "
          f"{va['patch']}, the CLI's dim 768, 12 + 12 blocks, 12 heads; {sum(p.numel() for p in res['tokenizer'].net.parameters()) / 1e6:.1f}M "
          f"params; exact fp32): steps {[round(s * 1e3, 1) for s in seconds]} ms, median "
          f"{step_ms:.1f} ms, {B / step_ms * 1e3:.2f} clips/s, {flops / step_ms / 1e9:.1f} "
          f"TFLOP/s ({flops / step_ms / 1e9 / FP32_PEAK_TFLOPS:.1%} of the FP32 peak), launches "
          f"a step {VIDEO_STEP['fwd']} / {VIDEO_STEP['dq']} / {VIDEO_STEP['dkv']}; first loss "
          f"{metrics[0]['loss']:.4f}; the CLI run {run_s:.1f} s with its eval "
          f"(random LPIPS / Inception: lpips {log[-1]['eval_lpips']:.4f}, fid "
          f"{log[-1]['eval_fid']:.2f}, IS {log[-1]['eval_inception_score']:.3f}; ms_ssim "
          f"{log[-1].get('eval_ms_ssim', float('nan')):.4f}, psnr {log[-1]['eval_psnr']:.2f})")
    ckpt = os.path.join(out, "checkpoint-final.pth")
    t0 = time.perf_counter()
    paths = run_training_vqvae.main(argv + ["--tokenize", "--resume", ckpt, "--tokenize_path",
                                            tok_dir, "--tokenize_save_path", out])
    tokens = [np.load(p)["arr_0"] for p in paths]
    grid = (va["frames"] // va["tubelet"], va["size"] // va["patch"], va["size"] // va["patch"])
    if any(t.shape != grid or t.dtype != np.int16 or t.min() < 0 or t.max() >= 256
           for t in tokens):
        raise AssertionError(f"--tokenize: {[(t.shape, t.dtype) for t in tokens]}")
    print(f"--tokenize of {len(paths)} clips: {time.perf_counter() - t0:.2f} s, {grid} int16 "
          "tokens each")
    # one step, the kernels against their plain versions
    net, optimizer = res["tokenizer"].net, res["optimizer"]
    gen = torch.Generator(device=dev).manual_seed(18)
    batch = torch.rand((B, va["frames"], va["size"], va["size"], 3), generator=gen,
                       device=dev) * 2 - 1
    video_step_check(net, batch, "video VQ-VAE step")
    # a profiled step
    from torch.profiler import ProfilerActivity, profile
    step_fn = make_vqvae_train_step(net, optimizer)
    step_fn(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _device_breakdown(prof, "video VQ-VAE step", wall_ms, step_ms, top=12)
    # rows 3-5 at this step's shape: the no-mask 2048^2 case of the training kernel phase
    no_mask = [r for r in train_rows if r["case"] == "self-attention, 2048^2, no mask"]
    for r in no_mask:
        print(f"rows 3-5 at the video step's shape (B={B}, 2048^2, 12 heads of 64, no mask, "
              f"{r['mode']}): kernel ms " + " ".join(f"{k} {v:.3f}" for k, v in r["ms"].items())
              + f"; bounds fwd {attention_bound_ms(2, B, HEADS, 2048, 2048, 64)[0]:.3f}, dq "
              f"{attention_bound_ms(3, B, HEADS, 2048, 2048, 64, 3, 2)[0]:.3f}, dk/dv "
              f"{attention_bound_ms(4, B, HEADS, 2048, 2048, 64, 2, 4)[0]:.3f}; "
              f"scaled_dot_product_attention fwd {r['library_ms']['fwd']:.3f}, bwd "
              f"{r['library_ms']['bwd']:.3f}; errors "
              + " ".join(f"{k} {v:.2e}" for k, v in r["err"].items()))
    return {"launches": VIDEO_STEP, "step_ms": step_ms, "no_mask": no_mask[0], "net": net,
            "optimizer": optimizer, "clips": clips}


def video_step_check(net, batch, label):
    """The video VQ-VAE's loss and gradients on `batch` with the kernels
    (VIDEO_STEP's launches) against the plain versions, within
    STEP_LOSS_RTOL and STEP_GRAD_REL_L2; the codebook state restored after
    each run."""
    from egom2p_torch.train.vqvae_train import reconst_loss

    st = net.quantize.state
    saved = type(st)(embed=st.embed.clone(), cluster_size=st.cluster_size.clone(),
                     initted=st.initted.clone())

    def grads():
        net.zero_grad(set_to_none=True)
        pred, commit, _ = net.autoencode_train(batch)
        loss = reconst_loss(pred, batch, "mse", 3) + commit
        loss.backward()
        net.quantize.set_state(saved)
        return loss.item(), [p.grad.float().clone() for p in net.parameters()]

    before = _counts()
    loss_k, g_k = grads()
    after = _counts()
    if {k: after[k] - before[k] for k in after} != VIDEO_STEP:
        raise AssertionError(f"{label}: the check missed a kernel")
    with _swapped(_plain_versions("default")):
        loss_p, g_p = grads()
    num = math.sqrt(sum(((a - b) ** 2).sum().item() for a, b in zip(g_k, g_p)))
    den = math.sqrt(sum((b ** 2).sum().item() for b in g_p))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"{label}, kernels vs plain versions: loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(rel {loss_rel:.2e}; tolerance {STEP_LOSS_RTOL:g}), gradient rel L2 difference "
          f"{num / den:.2e} (tolerance {STEP_GRAD_REL_L2:g})")
    if not math.isfinite(loss_k) or loss_rel > STEP_LOSS_RTOL or num / den > STEP_GRAD_REL_L2:
        raise AssertionError(f"{label}: the kernels disagree with the plain versions")
    net.zero_grad(set_to_none=True)


def _teacher_attention_row(dev, spec, heads, hd):
    """The attention kernel of a teacher's block at its shape (B, 257
    tokens, no mask) against its plain version, timed, with its bound and
    scaled_dot_product_attention."""
    import egom2p_torch.ops.flash64_train as ft
    import egom2p_torch.ops.flash_attention as fa

    n = 1 + spec.grid ** 2
    rng = np.random.default_rng(19)
    C = heads * hd
    qkv = _randn(rng, (TEACHER_B, n, 3 * C), dev)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    if hd == 64:
        kernel = lambda: ft.flash64_train_fwd(q, k, v)  # noqa: E731
        plain = lambda: ft.flash64_train_reference_fwd(q, k, v, None, None, False)  # noqa: E731
    else:  # the stock route's packed operands at the kernel's width 80
        kw = dict(hd=hd, sm_scale=hd ** -0.5)
        qp, kp, vp = (t.contiguous() for t in (q, k, v))
        kernel = lambda: fa.flash_attention_fwd(qp, kp, vp, **kw)  # noqa: E731
        plain = lambda: ft.flash64_train_reference_fwd(qp, kp, vp, None, None, True, **kw)  # noqa
    o, _ = kernel()
    ro, _ = plain()
    err = (o.float() - ro.float()).abs().max().item()
    ms, plain_ms = _cuda_time_ms(kernel, 20), _cuda_time_ms(plain, 3, 1)
    lib, _, _ = _sdpa_ms(*(_split_heads(t, heads) for t in (q, k, v)), reps=20)
    bound = attention_bound_ms(2, TEACHER_B, heads, n, n, hd)
    print(f"{spec.name} attention (B={TEACHER_B}, {n} tokens, {heads} heads of {hd}, no mask): "
          f"max_abs_err {err:.2e}, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}), scaled_dot_product_attention {lib:.4f} ms")
    if err > TRAIN_O_ATOL:
        raise AssertionError(f"{spec.name}: the attention kernel disagrees with plain: {err}")
    return {"shape": [TEACHER_B, n, heads, hd], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib}


def teacher_check(dev, domain, wrapper, expected):
    """One bf16 forward of a full-size random teacher at B = TEACHER_B,
    the kernels against their plain versions; `expected` launches of
    `wrapper` (a key of _counts) in the kernel run."""
    from egom2p_torch.models.teachers import get_feature_extractor

    teacher, spec = get_feature_extractor(domain, None,
                                          torch.Generator(device=dev).manual_seed(20), dev)
    if spec.layerscale:  # at its init of 1e-5 LayerScale hides every block from the map
        for blk in teacher.blocks:
            blk.ls1.data.fill_(1.0)
            blk.ls2.data.fill_(1.0)
    teacher = teacher.to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.rand((TEACHER_B, 224, 224, 3), generator=gen, device=dev) * 2 - 1
    with torch.no_grad():
        before = _counts()
        feats_k = teacher(x).float()
        launches = _counts()[wrapper] - before[wrapper]
        with _swapped(_plain_versions("default") + _plain_versions("large")):
            feats_p = teacher(x).float()
    rel = _rel_l2(feats_k, feats_p)
    n_params = sum(p.numel() for p in teacher.parameters()) / 1e6
    print(f"{domain} teacher (bf16, random weights, {n_params:.1f}M params), B={TEACHER_B}: "
          f"features {tuple(feats_k.shape)}, kernels vs plain relative L2 {rel:.2e} (tolerance "
          f"{TEACHER_REL_L2:g}), {launches} {wrapper} launches")
    if launches != expected or not torch.isfinite(feats_k).all() or rel > TEACHER_REL_L2:
        raise AssertionError(f"{domain} teacher: {launches} launches, rel L2 {rel}")
    del teacher
    return spec, launches


def feature_vqvae_phase(dev, tmp):
    """Phase 5i (docstring): cfgs/vqvae/clip_b16.yaml at B = 64 on a random
    bf16 CLIP-B16 teacher, then DINOv2-B14 and ImageBind-H14 forwards.
    Returns {"step_ms", "dino": row 3's teacher row, "imagebind": row 9's}."""
    from egom2p_torch.cli import run_training_vqvae

    imgs = np.random.default_rng(22).integers(0, 256, (FEATURE_IMAGES, 224, 224, 3),
                                              dtype=np.uint8)
    data = os.path.join(tmp, "images.npy")
    np.save(data, imgs)
    try:
        import yaml  # noqa: F401
        cfg = os.path.join(REPO_DIR, "cfgs/vqvae/clip_b16.yaml")
    except ImportError:
        cfg = os.path.join(tmp, "clip_b16.json")
        with open(cfg, "w") as f:
            json.dump(CLIP_B16_CONFIG, f)
    seconds = []
    _reset_counts()
    t0 = time.perf_counter()
    res = run_training_vqvae.main(
        ["--config", cfg, "--data_path", data, "--epochs", "1", "--warmup_epochs", "0",
         "--eval_freq", "0", "--async_save", "false", "--print_freq", "1",
         "--output_dir", os.path.join(tmp, "clip_b16"), "--device", "cuda"],
        on_step=lambda step, metrics, secs: seconds.append(secs))
    launches = _counts()
    b = CLIP_B16_CONFIG["batch_size"]
    step_ms = float(np.median(seconds[1:])) * 1e3
    print(f"CLIP-B16 feature VQ-VAE ({os.path.basename(cfg)}: dim 768, 12 + 12 blocks, 8192 "
          f"codes; random bf16 CLIP-B16 teacher), B={b}: steps "
          f"{[round(s * 1e3, 1) for s in seconds]} ms, median {step_ms:.1f} ms, "
          f"{b / step_ms * 1e3:.1f} images/s, first loss {res['metrics'][0]['loss']:.4f}; "
          f"kernel launches {launches} (196 + 197 tokens: the dense path); "
          f"{time.perf_counter() - t0:.1f} s with the teacher and the data")
    if not all(math.isfinite(m["loss"]) for m in res["metrics"]) or any(launches.values()):
        raise AssertionError("CLIP-B16 feature VQ-VAE: non-finite loss or a kernel launched")
    del res
    torch.cuda.empty_cache()
    dino, _ = teacher_check(dev, "DINOv2-B14", "fwd", 12)
    dino_row = _teacher_attention_row(dev, dino, 12, 64)
    imagebind, _ = teacher_check(dev, "ImageBind-H14", "stock_fwd", 32)
    imagebind_row = _teacher_attention_row(dev, imagebind, 16, 80)
    return {"step_ms": step_ms, "dino": dino_row, "imagebind": imagebind_row}


def sam_dense_phase(dev, served, tmp):
    """Phase 3f (docstring): generate_sam_dense at width 768, 2 + 2 blocks.
    Returns the flash64 launches."""
    from egom2p_torch.data.modality_info import MODALITY_INFO
    from egom2p_torch.generate.sampler import (GenerationSampler, init_empty_target_modality,
                                               init_full_input_modality)
    from egom2p_torch.generate.schedules import build_chained_generation_schedules
    from egom2p_torch.models.egom2p import create_model
    from egom2p_torch.ops.flash64 import flash64_attention
    from egom2p_torch.utils.text_tokenizer import load_text_tokenizer, write_wordpiece_json

    tok = load_text_tokenizer(write_wordpiece_json(os.path.join(tmp, "sam_tokenizer.json"),
                                                   CAPTION_WORDS))
    mods = ("caption", "tok_rgb")
    model = create_model(BASE_MODEL, mods, mods, device=dev, encoder_depth=2,
                         decoder_depth=2).eval()
    model.init_random_(torch.Generator(device=dev).manual_seed(23))
    rgb = served["rgb"][:1].reshape(1, -1).cpu().numpy().astype(np.int32)
    md = {"tok_rgb": {"tensor": rgb}}
    init_full_input_modality(md, MODALITY_INFO, "tok_rgb")
    init_empty_target_modality(md, MODALITY_INFO, "caption", 1, SAM_SLOTS)
    schedule = build_chained_generation_schedules(
        ["tok_rgb"], ["caption"], [SAM_SLOTS], ["autoregressive"], [0], ["linear"], [0.01],
        ["constant"], [1.0], ["constant"])
    flash64_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = GenerationSampler(model).generate_sam_dense(md, schedule, tok, batch_size=SAM_BATCH,
                                                      key="caption", top_p=0.8, seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    seq = out["caption"]["tensor"]
    launches = flash64_attention.launches
    print(f"generate_sam_dense (EgoM2P-base width, 2 + 2 blocks, caption + tok_rgb; "
          f"{SAM_BATCH} sequences over one clip's rgb tokens, {SAM_SLOTS} slots): "
          f"{seconds * 1e3:.1f} ms, merged sequence {seq.shape[1]} ids, {launches} flash64 "
          "launches")
    if seq.shape[0] != 1 or seq.shape[1] < 1 or seq.min() < 0 \
            or seq.max() >= MODALITY_INFO["caption"]["vocab_size"] or launches < 2:
        raise AssertionError(f"generate_sam_dense: {seq.shape}, {launches} launches")
    return launches


# ---------------------------------------------------------------- phase 3g
IMAGE_SIDE = 1000          # the seeded uint8 image, B = 1: padded to 1008 at f16, 1000 at f8
IMAGE_JIT_SIDE = 64        # the input the encoder.jit / decoder.jit files are traced on
CV_FRAMES = 33             # two windows of the CV tokenizers: 17 + 16 frames
LATENT_MOVE = 1e-3         # a latent element "moved by TF32": by more than this share of the max
SERVE_REPS = 2             # timed calls after a warm-up, per precision


def _flash_launches() -> int:
    """Every attention and CE kernel launch so far (the training wrappers'
    counts and the serving forward's)."""
    from egom2p_torch.ops.flash64 import flash64_attention
    return sum(_counts().values()) + flash64_attention.launches


def _exact_and_tf32(tok, fn):
    """fn() with the tokenizer's convs and products in exact fp32 and on
    TF32 (median ms of SERVE_REPS calls after a warm-up): ({tf32: ms},
    {tf32: the last result}); exact fp32 after."""
    ms, out = {}, {}
    for tf32 in (False, True):
        tok.encode_tf32 = tok.decode_tf32 = tf32
        ms[tf32], out[tf32] = _median_ms(fn, SERVE_REPS)
    tok.encode_tf32 = tok.decode_tf32 = False
    return ms, out


def _moved(exact: torch.Tensor, tf32: torch.Tensor, discrete: bool) -> int:
    """Tokens TF32 changed, or latent elements it moved by more than
    LATENT_MOVE of the exact latent's largest magnitude."""
    if discrete:
        return int((exact != tf32).sum())
    return int(((exact.float() - tf32.float()).abs() > LATENT_MOVE * exact.abs().max()).sum())


def image_tokenizer_check(dev, tmp, name, cfg, discrete, image):
    """One Cosmos image tokenizer at full width: random weights from a seed
    written to encoder.jit / decoder.jit and loaded back (bitwise), then
    the seeded image through ImageTokenizer.forward and its encode in exact
    fp32 and on TF32; for DI the array half of tokenize_images --save_codes
    (encode -> _codes.npy -> decode).  Returns its numbers."""
    from egom2p_torch.core import checkpoint
    from egom2p_torch.tokenizers.cosmos.image_api import (ImageTokenizer, pad_image_batch,
                                                          unpad_image_batch)
    from egom2p_torch.tokenizers.cosmos.video_api import numpy2tensor, tensor2numpy

    made = ImageTokenizer.random_init(torch.Generator(dev).manual_seed(31), cfg,
                                      discrete=discrete)
    t0 = time.perf_counter()
    enc, dec = checkpoint.save_cosmos_image_jit(made.net, os.path.join(tmp, name),
                                                IMAGE_JIT_SIDE)
    tok = checkpoint.load_cosmos_image_pth(enc, dec, cfg, discrete, dev)
    io_s = time.perf_counter() - t0
    if any(not torch.equal(v, tok.net.state_dict()[k]) for k, v in made.net.state_dict().items()):
        raise AssertionError(f"{name}: encoder.jit / decoder.jit do not load back bitwise")
    n_params = sum(p.numel() for p in made.net.parameters())
    del made
    padded, crop = pad_image_batch(image, cfg.spatial_compression)
    x = torch.from_numpy(numpy2tensor(padded)).to(dev)
    enc_ms, encoded = _exact_and_tf32(tok, lambda: tok.encode(x)[0])
    fwd_ms, recon = _exact_and_tf32(tok, lambda: tok.forward(image))
    moved = _moved(encoded[False], encoded[True], discrete)
    recon = recon[False]
    decoded = tok.decode(encoded[False])
    if recon.shape != image.shape or recon.dtype != np.uint8 or not bool(
            torch.isfinite(decoded).all()) or not bool(torch.isfinite(encoded[False].float()).all()):
        raise AssertionError(f"{name}: recon {recon.shape} {recon.dtype}, non-finite values")
    line = ""
    if discrete:  # tokenize_images --save_codes: the codes through a file, then the decode
        path = os.path.join(tmp, f"{name}_codes.npy")
        np.save(path, encoded[False][0].cpu().numpy().astype(np.int32))
        back = torch.from_numpy(np.load(path))[None].to(dev)
        via_file = unpad_image_batch(tensor2numpy(tok.decode(back)), crop)
        if not torch.equal(back, encoded[False]) or \
                np.abs(via_file.astype(int) - recon.astype(int)).max() > DECODE_PIXEL_LEVELS:
            raise AssertionError(f"{name}: the codes file does not decode to the reconstruction")
        line = f"; _codes.npy {tuple(back.shape[1:])} int32 decoded within a level"
    what = "tokens" if discrete else "latent elements"
    print(f"{name} ({n_params / 1e6:.1f}M params; {IMAGE_SIDE}^2 uint8 image padded to "
          f"{padded.shape[1]}x{padded.shape[2]}, B = 1): encode exact fp32 {enc_ms[False]:.1f} ms"
          f", TF32 {enc_ms[True]:.1f} ms -> {tuple(encoded[False].shape)}; forward exact "
          f"{fwd_ms[False]:.1f} ms, TF32 {fwd_ms[True]:.1f} ms; TF32 moves {moved} of "
          f"{encoded[False].numel()} {what}; jit files written and loaded back in {io_s:.1f} s"
          + line)
    return {"encode_ms": enc_ms, "forward_ms": fwd_ms, "moved": moved}


def video_tokenizer_check(dev, name, tok, clip, discrete):
    """A CV tokenizer's forward over the whole clip (window by window), or
    the DV BASE tokenizer's tokens of one window and their decode, in exact
    fp32 and on TF32; the encode's first window both ways.  Returns its
    numbers."""
    from egom2p_torch.tokenizers.cosmos.video_api import numpy2tensor, pad_video_batch

    window = clip[:, :17]
    if discrete:
        dev_window = torch.from_numpy(window).to(dev)
        enc_ms, encoded = _exact_and_tf32(tok, lambda: tok.forward(dev_window, device_out=True))
        fwd_ms, out = _exact_and_tf32(tok, lambda: tok.decode(encoded[False]))
        out = out[False]
        shape = window.shape
    else:
        padded, _ = pad_video_batch(window, 2 * tok.cfg.temporal_compression,
                                    2 * tok.cfg.spatial_compression)
        x = torch.from_numpy(numpy2tensor(padded)).to(dev)
        enc_ms, encoded = _exact_and_tf32(tok, lambda: tok.encode(x)[0])
        fwd_ms, out = _exact_and_tf32(tok, lambda: tok.forward(clip))
        out = torch.from_numpy(out[False])
        shape = clip.shape
    moved = _moved(encoded[False], encoded[True], discrete)
    if tuple(out.shape) != tuple(shape) or not bool(torch.isfinite(out.float()).all()) or \
            not bool(torch.isfinite(encoded[False].float()).all()):
        raise AssertionError(f"{name}: output {tuple(out.shape)}, or non-finite values")
    what = "tokens" if discrete else "latent elements"
    n_params = sum(p.numel() for p in tok.net.parameters())
    print(f"{name} ({n_params / 1e6:.1f}M params, B = 1): encode of a 17-frame "
          f"{clip.shape[2]}^2 window "
          f"exact fp32 {enc_ms[False]:.1f} ms, TF32 {enc_ms[True]:.1f} ms -> "
          f"{tuple(encoded[False].shape)}; "
          + (f"decode exact {fwd_ms[False]:.1f} ms, TF32 {fwd_ms[True]:.1f} ms"
             if discrete else f"forward of {clip.shape[1]} frames (two windows) exact "
             f"{fwd_ms[False]:.1f} ms, TF32 {fwd_ms[True]:.1f} ms")
          + f"; TF32 moves {moved} of {encoded[False].numel()} {what}")
    return {"encode_ms": enc_ms, "forward_ms": fwd_ms, "moved": moved}


def cosmos_serve_phase(dev, tmp):
    """Phase 3g (docstring): the rest of Cosmos at full width.  Returns
    {tokenizer: its numbers}."""
    import dataclasses

    from egom2p_torch.tokenizers.cosmos import image_network as imn
    from egom2p_torch.tokenizers.cosmos import network as vnet
    from egom2p_torch.tokenizers.cosmos.video_api import (CausalVideoTokenizer,
                                                          ContinuousVideoTokenizer)

    before = _flash_launches()
    rng = np.random.default_rng(30)
    image = rng.integers(0, 256, (1, IMAGE_SIDE, IMAGE_SIDE, 3), dtype=np.uint8)
    side = VIDEO_ARGS["size"]
    clip = rng.integers(0, 256, (1, CV_FRAMES, side, side, 3), dtype=np.uint8)
    out = {}
    for name, cfg, discrete in (("DI16x16", imn.DI_CONFIG, True),
                                ("CI16x16", imn.CI_CONFIG, False),
                                ("DI8x8", imn.DI8x8_CONFIG, True)):
        out[name] = image_tokenizer_check(dev, tmp, name, cfg, discrete, image)
    for name, cfg in (("CV8x8x8", vnet.CV8x8x8_CONFIG), ("CV4x8x8", vnet.CV4x8x8_CONFIG)):
        tok = ContinuousVideoTokenizer.random_init(torch.Generator(dev).manual_seed(32), cfg)
        out[name] = video_tokenizer_check(dev, name, tok, clip, False)
        del tok
    cfg = dataclasses.replace(vnet.DV4x8x8_CONFIG, encoder="BASE", decoder="BASE")
    net = vnet.CausalDiscreteVideoTokenizer(cfg).to(dev)
    tok = CausalVideoTokenizer(net.init_random_(torch.Generator(dev).manual_seed(33)))
    out["DV4x8x8-BASE"] = video_tokenizer_check(dev, "DV4x8x8 BASE", tok, clip, True)
    del tok, net
    launches = _flash_launches() - before
    print(f"Cosmos phase: {launches} attention kernel launches (every Cosmos attention is dense)")
    if launches:
        raise AssertionError(f"the Cosmos tokenizers launched {launches} attention kernels")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 5j
MEMCODES_SAMPLES = 512     # cam trajectories: an epoch of 4 steps at the config's B = 128


def _moved_parameters(res, argv, dev):
    """The names of the trained tokenizer's tensors still equal to their
    init (the same seed's build)."""
    from egom2p_torch.cli import run_training_vqvae as rtv
    init = rtv.build_tokenizer(rtv.get_args(argv), dev, torch.Generator(dev).manual_seed(0))
    start = init.net.state_dict()
    return [k for k, v in res["tokenizer"].net.state_dict().items() if torch.equal(v, start[k])]


def grad_vqvae_phase(dev, tmp):
    """Phase 5j (docstring): the gradient quantizers through the VQ-VAE CLI.
    Returns {"launches": per taming video step, "step_ms": x}."""
    from egom2p_torch.cli import run_training_vqvae as rtv
    from egom2p_torch.data.cam_gaze import smooth_cam_trajectories
    from egom2p_torch.train.vqvae_train import reconst_loss

    va = VIDEO_ARGS
    clips = os.path.join(tmp, "video_clips")
    if not os.path.isdir(clips):
        _write_video_clips(clips, VIDEO_CLIPS, VIDEO_CLIP_FRAMES, va["size"], 16)
    out = os.path.join(tmp, "video_taming")
    argv = ["--domain", "rgb", "--data_path", clips, "--use_npy", "--num_frames",
            str(va["frames"]), "--input_size", str(va["size"]), "--tubelet_size",
            str(va["tubelet"]), "--patch_size", str(va["patch"]), "--batch_size", str(B),
            "--epochs", "1", "--warmup_epochs", "0", "--eval_freq", "0", "--quantizer_type",
            "taming", "--output_dir", out, "--async_save", "false", "--print_freq", "1",
            "--device", "cuda"]
    per_step, seconds = [], []

    def on_step(step, metrics, secs):
        per_step.append(_counts())
        seconds.append(secs)

    _reset_counts()
    res = rtv.main(argv, on_step=on_step)
    prev = {k: 0 for k in per_step[0]}
    for i, counts in enumerate(per_step):
        step = {k: counts[k] - prev[k] for k in counts}
        prev = counts
        if step != VIDEO_STEP:
            raise AssertionError(f"taming video step {i}: launches {step}, expected {VIDEO_STEP}")
    metrics = res["metrics"]
    if len(metrics) != VIDEO_CLIPS // B or not all(math.isfinite(v) for m in metrics
                                                   for v in m.values()):
        raise AssertionError(f"taming video VQ-VAE: metrics {metrics}")
    still = _moved_parameters(res, argv, dev)
    if still:
        raise AssertionError(f"taming video VQ-VAE: unmoved {still[:5]}")
    step_ms = float(np.median(seconds[1:])) * 1e3
    flops = video_vqvae_flops_per_sample(va["frames"], va["size"], va["tubelet"], va["patch"]) * B
    net = res["tokenizer"].net
    # one step's loss and gradients, the kernels against their plain versions
    batch = torch.rand((B, va["frames"], va["size"], va["size"], 3),
                       generator=torch.Generator(device=dev).manual_seed(34), device=dev) * 2 - 1

    def grads():
        net.zero_grad(set_to_none=True)
        pred, qloss, _ = net.autoencode_train(batch, True)
        loss = reconst_loss(pred, batch, "mse", 3) + qloss
        loss.backward()
        return loss.item(), [p.grad.float().clone() for p in net.parameters()]

    before = _counts()
    loss_k, g_k = grads()
    after = _counts()
    if {k: after[k] - before[k] for k in after} != VIDEO_STEP:
        raise AssertionError("the taming step check missed a kernel")
    with _swapped(_plain_versions("default")):
        loss_p, g_p = grads()
    num = math.sqrt(sum(((a - b) ** 2).sum().item() for a, b in zip(g_k, g_p)))
    den = math.sqrt(sum((b ** 2).sum().item() for b in g_p))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    net.zero_grad(set_to_none=True)
    del g_k, g_p
    print(f"taming video VQ-VAE (rgb at the CLI's video defaults, 256 codes, "
          f"{sum(p.numel() for p in net.parameters()) / 1e6:.1f}M params, exact fp32, B = {B}): "
          f"steps {[round(s * 1e3, 1) for s in seconds]} ms, median {step_ms:.1f} ms, "
          f"{B / step_ms * 1e3:.2f} clips/s, {flops / step_ms / 1e9:.1f} TFLOP/s; launches a step "
          f"{VIDEO_STEP['fwd']} / {VIDEO_STEP['dq']} / {VIDEO_STEP['dkv']}; losses "
          f"{metrics[0]['loss']:.4f} -> {metrics[-1]['loss']:.4f} (code loss "
          f"{metrics[-1]['code_loss']:.4f}); every parameter and the codebook moved; kernels vs "
          f"plain: loss rel {loss_rel:.2e} (tolerance {STEP_LOSS_RTOL:g}), gradient rel L2 "
          f"{num / den:.2e} (tolerance {STEP_GRAD_REL_L2:g})")
    if not math.isfinite(loss_k) or loss_rel > STEP_LOSS_RTOL or num / den > STEP_GRAD_REL_L2:
        raise AssertionError("the taming step with the kernels disagrees with plain")
    del res, net, batch
    torch.cuda.empty_cache()

    # Memcodes on cam at cfgs/vqvae/cam.yaml's widths, and --tokenize
    rng = np.random.default_rng(35)
    data = os.path.join(tmp, "memcodes_cam.npy")
    np.save(data, smooth_cam_trajectories(rng, MEMCODES_SAMPLES)[1].astype(np.float32))
    clip_file = os.path.join(tmp, "memcodes_clips.npy")
    np.save(clip_file, smooth_cam_trajectories(rng, 16)[1].astype(np.float32))
    out = os.path.join(tmp, "cam_memcodes")
    argv = ["--config", vqvae_configs(tmp)["cam"], "--data_path", data, "--quantizer_type",
            "memcodes", "--epochs", "1", "--warmup_epochs", "0",
            "--num_eval_metrics_samples", "128", "--output_dir", out, "--async_save", "false",
            "--print_freq", "4", "--device", "cuda"]
    seconds = []
    before = _flash_launches()
    res = rtv.main(argv, on_step=lambda s, m, sec: seconds.append(sec))
    metrics = res["metrics"]
    if len(metrics) != MEMCODES_SAMPLES // VQ_B or not all(
            math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"memcodes cam VQ-VAE: metrics {metrics}")
    still = _moved_parameters(res, argv, dev)
    if still:
        raise AssertionError(f"memcodes cam VQ-VAE: unmoved {still[:5]}")
    t0 = time.perf_counter()
    path = rtv.main(argv + ["--tokenize", "--resume", os.path.join(out, "checkpoint-final.pth"),
                            "--tokenize_path", clip_file, "--tokenize_save_path", out])
    tok_s = time.perf_counter() - t0
    tokens = np.load(path)["arr_0"]
    launches = _flash_launches() - before
    if tokens.shape != (16, 30) or tokens.dtype != np.int16 or tokens.min() < 0 \
            or tokens.max() >= 256 or launches:
        raise AssertionError(f"memcodes --tokenize: {tokens.shape} {tokens.dtype}, "
                             f"{launches} kernel launches")
    log = [json.loads(line) for line in open(os.path.join(out, "log.txt"))]
    cam_ms = float(np.median(seconds[1:])) * 1e3
    print(f"memcodes cam VQ-VAE (cfgs/vqvae/cam.yaml's widths, 256 codes, B = {VQ_B}, exact "
          f"fp32): steps {[round(s * 1e3, 1) for s in seconds]} ms, median {cam_ms:.1f} ms "
          f"({VQ_B / cam_ms * 1e3:.0f} samples/s); losses {metrics[0]['loss']:.4f} -> "
          f"{metrics[-1]['loss']:.4f}; eval usage {log[-1]['eval_codebook_usage']:.3f}; "
          f"--tokenize of 16 clips {tok_s:.2f} s -> (16, 30) int16; 0 kernel launches "
          "(30 tokens: the dense path)")
    return {"launches": VIDEO_STEP, "step_ms": step_ms, "cam_memcodes_ms": cam_ms}


# ---------------- the hub, LoRA, augmented clips and the folder dataset
HUB_LAYOUTS = (("safetensors", "model.safetensors"), ("pth_dir", "egom2p-base.pth"),
               ("bare_pth", None))
SUBSET_ROWS = 1707             # one ROAR step's chosen positions at B = 8 (ROADMAP)
LORA_RANK, LORA_STEPS, LORA_LR = 4, 4, 1e-3
LORA_STEP = DEFAULT_STEP       # 36 / 36 / 36 / 2: the base step's kernels through the merged weights
MERGE_LOSS_RTOL = 1e-3         # merge_lora + a plain forward vs the adapted forward (bf16 noise)
AUG_SPEC, AUG_REPROB = "rand-m9-n2-mstd0.5", 0.25
AUG_STEPS, AUG_WORKERS = 3, 6
FOLDER_CLASSES, FOLDER_PER_CLASS, FOLDER_SIZE = 2, 16, 224
FOLDER_SOURCE = (256, 320)     # the stored frames' (h, w): resized to 224 after the crop


def hub_phase(dev, served, tmp):
    """Phase 3h (docstring): served's EgoM2P-base written in three layouts
    and loaded back through FM.from_pretrained on the card; greedy
    rgb2depth on the safetensors load and forward_dec_subset_logits.
    Returns the flash64 launches of the generate."""
    from egom2p_torch.cli.eval_common import MODS4, roar_schedule
    from egom2p_torch.generate.sampler import GenerationSampler
    from egom2p_torch.models.hub import FM
    from egom2p_torch.ops.attention import inference_attention
    from egom2p_torch.ops.flash64 import flash64_attention

    model = served["model"]
    ref = model.state_dict()
    loaded = None
    for layout, weights in HUB_LAYOUTS:
        root = os.path.join(tmp, f"hub_{layout}")
        t0 = time.perf_counter()
        if weights is None:  # a bare .pth with the reference's pickled args
            os.makedirs(root, exist_ok=True)
            target = os.path.join(root, "egom2p-base.pth")
            torch.save({"model": {k: v.cpu() for k, v in ref.items()},
                        "args": argparse.Namespace(model=BASE_MODEL, in_domains=list(MODS4),
                                                   out_domains=list(MODS4))}, target)
        else:
            FM(model).save_pretrained(root, weights)
            target = root
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))
        t0 = time.perf_counter()
        fm = FM.from_pretrained(target, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        sd = fm.model.state_dict()
        if set(sd) != set(ref) or not all(sd[k].device == v.device and torch.equal(sd[k], v)
                                          for k, v in ref.items()):
            raise AssertionError(f"hub {layout}: the loaded weights differ from served's")
        print(f"hub {layout}: {size / 2 ** 30:.2f} GiB written in {write_s:.2f} s, "
              f"FM.from_pretrained on the card in {load_s:.2f} s, {len(sd)} tensors bitwise "
              "equal to served's")
        for f in os.listdir(root):
            os.remove(os.path.join(root, f))
        if layout == "safetensors":
            loaded = fm.model
        else:
            del fm
    # greedy rgb2depth on the safetensors load: served's tokens (head_check, seed 5)
    sampler = GenerationSampler(loaded)
    schedule = roar_schedule("tok_rgb", "tok_depth", temperature=0.0)
    flash64_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sampler.generate(_rgb2depth_sample(served["rgb"]), schedule, seed=5)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    launches = flash64_attention.launches
    tokens = np.asarray(out["tok_depth"]["tensor"])
    unequal = int((tokens != served["greedy_depth"]).sum())
    print(f"hub: greedy rgb2depth at B={B} on the model.safetensors load: {gen_ms:.1f} ms, "
          f"flash64 launches {launches}, {unequal} of {tokens.size} tokens unlike served's")
    if launches != LAUNCHES_PER_GENERATE or unequal:
        raise AssertionError(f"hub generate: {launches} launches, {unequal} tokens differ")
    # forward_dec_subset_logits on one step's chosen positions
    md = {m: {k: torch.as_tensor(v).to(dev) for k, v in d.items()}
          for m, d in _rgb2depth_sample(served["rgb"]).items()}
    gen = torch.Generator(device=dev).manual_seed(19)
    ids_keep = torch.stack([torch.randperm(5120, generator=gen, device=dev)[:SUBSET_ROWS]
                            for _ in range(B)])
    with torch.inference_mode(), inference_attention():
        ctx, mask = loaded.forward_enc_context(md, 5120)
        logits = loaded.forward_dec_subset_logits(md, "tok_depth", ctx, mask, ids_keep)
        y = loaded.forward_dec_subset_hidden(md, "tok_depth", ctx, mask, ids_keep)
        pair = loaded.forward_mod_logits("tok_depth", y)
    same = bool(torch.equal(logits, pair))
    print(f"hub: forward_dec_subset_logits at ({B}, {SUBSET_ROWS}) positions: logits "
          f"{tuple(logits.shape)} {logits.dtype}, bitwise equal to forward_mod_logits("
          f"forward_dec_subset_hidden): {same}")
    if not same or logits.shape != (B, SUBSET_ROWS, 64000) or not torch.isfinite(logits).all():
        raise AssertionError("forward_dec_subset_logits disagrees with its two halves")
    del logits, pair, y, ctx, loaded, sampler
    torch.cuda.empty_cache()
    return launches


def _synthetic_batch(dev):
    """One batch of phase 5's synthetic data (the trainer's seeded pool at
    main_mod4's settings, batch 8) on the card."""
    from egom2p_torch.cli import run_training
    from egom2p_torch.data.loader import batch_to_device

    with tempfile.TemporaryDirectory() as out_dir:
        args = run_training.get_args([
            "--synthetic_data", "--model", BASE_MODEL, "--num_input_tokens", "2048",
            "--num_target_tokens", "2048", "--batch_size", str(B), "--seed", "0",
            "--output_dir", out_dir])
        loader, _ = run_training.setup_data(args)
        it = iter(loader)
        try:
            return batch_to_device(next(it), dev)
        finally:
            it.close()


def lora_phase(dev, default_ms):
    """Phase 5k (docstring): LoRA fine-tuning of EgoM2P-base.  Returns the
    launches per step."""
    import copy

    from egom2p_torch.cli.run_training import MODS4
    from egom2p_torch.models.egom2p import create_model
    from egom2p_torch.models.lora import init_lora_params, lora_train_step_fn, merge_lora

    model = create_model(BASE_MODEL, sorted(MODS4), sorted(MODS4), device=dev)
    model.init_random_(torch.Generator(device=dev).manual_seed(0))
    base = {k: v.detach().clone() for k, v in model.named_parameters()}
    lora = init_lora_params(dict(model.named_parameters()),
                            torch.Generator(device=dev).manual_seed(1), rank=LORA_RANK)
    leaves = [t.requires_grad_(True) for ab in lora.values() for t in ab.values()]
    optimizer = torch.optim.AdamW(leaves, lr=LORA_LR, weight_decay=0.0)
    apply = lora_train_step_fn(model)
    batch = _synthetic_batch(dev)
    per_step, seconds, losses = [], [], []
    for step in range(LORA_STEPS):
        torch.cuda.synchronize()
        before = _counts()
        t0 = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        loss, _ = apply(lora, batch, 2048, 2048, "mod")
        loss.backward()
        optimizer.step()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        after = _counts()
        per_step.append({k: after[k] - before[k] for k in after})
        losses.append(loss.item())
    for i, launches in enumerate(per_step):
        if launches != LORA_STEP:
            raise AssertionError(f"LoRA step {i}: launches {launches}, expected {LORA_STEP}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"LoRA: non-finite losses {losses}")
    unchanged = all(torch.equal(p, base[k]) for k, p in model.named_parameters())
    no_base_grad = all(p.grad is None for p in model.parameters())
    adapter_grads = all(t.grad is not None and bool(t.grad.abs().max() > 0) for t in leaves)
    moved_b = all(bool(ab["b"].abs().max() > 0) for ab in lora.values())
    n_adapter = sum(t.numel() for t in leaves)
    step_ms = float(np.median(seconds[1:])) * 1e3
    print(f"LoRA fine-tuning of EgoM2P-base (rank {LORA_RANK}, {len(lora)} attention linears, "
          f"{n_adapter / 1e6:.2f}M adapter parameters, B={B}, AdamW lr {LORA_LR:g}): steps "
          f"{[round(s * 1e3, 1) for s in seconds]} ms (first is warm-up), median {step_ms:.1f} "
          f"ms beside the full step's {default_ms:.1f} ms (phase 5); losses "
          f"{[round(v, 4) for v in losses]}; launches a step {LORA_STEP['fwd']} / "
          f"{LORA_STEP['dq']} / {LORA_STEP['dkv']} / {LORA_STEP['ce_fwd']}; base weights "
          f"bitwise unchanged: {unchanged}; no base gradient: {no_base_grad}; every adapter "
          f"has a gradient: {adapter_grads}; every b moved: {moved_b}")
    if not (unchanged and no_base_grad and adapter_grads and moved_b):
        raise AssertionError("LoRA: the base moved or an adapter took no gradient")
    # the adapters' gradients, kernels against plain versions
    trained = {k: {n: t.detach().clone().requires_grad_(True) for n, t in ab.items()}
               for k, ab in lora.items()}

    def grads():
        for ab in trained.values():
            for t in ab.values():
                t.grad = None
        loss, _ = apply(trained, batch, 2048, 2048, "mod")
        loss.backward()
        return loss.item(), [t.grad.clone() for ab in trained.values() for t in ab.values()]

    before = _counts()
    loss_k, g_k = grads()
    after = _counts()
    if {k: after[k] - before[k] for k in after} != LORA_STEP:
        raise AssertionError("the LoRA gradient check missed a kernel")
    with _swapped(_plain_versions("default")):
        loss_p, g_p = grads()
    num = math.sqrt(sum(((a - b) ** 2).sum().item() for a, b in zip(g_k, g_p)))
    den = math.sqrt(sum((b ** 2).sum().item() for b in g_p))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    # merge_lora, then the model's own forward on the merged weights
    fused = copy.deepcopy(model)
    with torch.no_grad():
        for k, w in merge_lora(base, trained).items():
            fused.get_parameter(k).copy_(w)
        merged_loss = fused(batch, 2048, 2048, "mod")[0].item()
        adapted_loss = apply(trained, batch, 2048, 2048, "mod")[0].item()
    merge_rel = abs(merged_loss - adapted_loss) / abs(adapted_loss)
    print(f"LoRA, kernels vs plain versions: loss {loss_k:.6f} vs {loss_p:.6f} (rel "
          f"{loss_rel:.2e}; tolerance {STEP_LOSS_RTOL:g}), adapter gradient rel L2 difference "
          f"{num / den:.2e} (tolerance {STEP_GRAD_REL_L2:g}); merge_lora + the plain forward "
          f"{merged_loss:.6f} vs the adapted forward {adapted_loss:.6f} (rel {merge_rel:.2e}; "
          f"tolerance {MERGE_LOSS_RTOL:g})")
    if (loss_rel > STEP_LOSS_RTOL or num / den > STEP_GRAD_REL_L2
            or merge_rel > MERGE_LOSS_RTOL):
        raise AssertionError("LoRA: kernels, plain versions or the merged model disagree")
    del model, fused, optimizer, batch, g_k, g_p
    torch.cuda.empty_cache()
    return LORA_STEP


def augmented_video_phase(dev, video):
    """Phase 5l (docstring): the rgb video VQ-VAE step of phase 5h on
    RandAugment + random-erasing clips from VideoBatchLoader's forked
    workers.  Returns the launches per step."""
    from egom2p_torch.data.video_dataset import VideoBatchLoader, VideoClipDataset
    from egom2p_torch.train.vqvae_train import make_vqvae_train_step

    va = VIDEO_ARGS
    ds = VideoClipDataset(video["clips"], mode="train", clip_len=va["frames"],
                          crop_size=va["size"], domain="rgb", use_npy=True, seed=0,
                          auto_augment=AUG_SPEC, reprob=AUG_REPROB)
    loader = VideoBatchLoader(ds, batch_size=B, seed=0, num_workers=AUG_WORKERS,
                              prefetch=AUG_WORKERS)
    # the host alone, from a cold start: two rounds of batches from every
    # worker (the queue holds one round), nothing else running
    t0 = time.perf_counter()
    it = iter(loader)
    try:
        batches = [next(it) for _ in range(2 * AUG_WORKERS)]
        host_s = time.perf_counter() - t0
    finally:
        it.close()
    if any(p.is_alive() for p in it.workers):
        raise AssertionError("VideoBatchLoader left a worker running")
    host_batches = len(batches)
    host_rate = host_batches * B / host_s
    batches = batches[:AUG_STEPS + 1]
    for b in batches:
        if b.shape != (B, va["frames"], va["size"], va["size"], 3) or b.dtype != np.float32 \
                or not np.isfinite(b).all():
            raise AssertionError(f"augmented batch {b.shape} {b.dtype}")
    net, optimizer = video["net"], video["optimizer"]
    step_fn = make_vqvae_train_step(net, optimizer)
    check = torch.from_numpy(batches[0]).to(dev)
    video_step_check(net, check, "augmented video VQ-VAE step")
    per_step, seconds = [], []
    for b in batches[1:]:
        x = torch.from_numpy(b).to(dev)
        torch.cuda.synchronize()
        before = _counts()
        t0 = time.perf_counter()
        metrics = step_fn(x)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        after = _counts()
        per_step.append({k: after[k] - before[k] for k in after})
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"augmented video step: loss {loss}")
    for i, launches in enumerate(per_step):
        if launches != VIDEO_STEP:
            raise AssertionError(f"augmented video step {i}: launches {launches}")
    step_ms = float(np.median(seconds)) * 1e3
    print(f"augmented video VQ-VAE (RandAugment {AUG_SPEC!r}, random erasing p={AUG_REPROB}, "
          f"{AUG_WORKERS} forked workers): the host alone {host_rate:.2f} augmented clips/s "
          f"({host_batches} batches of {B} from a cold start in {host_s:.2f} s); "
          f"steps {[round(s * 1e3, 1) for s in seconds]} ms, median {step_ms:.1f} ms = "
          f"{B / step_ms * 1e3:.2f} clips/s on the card (phase 5h: {video['step_ms']:.1f} ms); "
          f"launches a step {VIDEO_STEP['fwd']} / {VIDEO_STEP['dq']} / {VIDEO_STEP['dkv']}")
    video.pop("net")
    video.pop("optimizer")
    del net, optimizer, step_fn
    torch.cuda.empty_cache()
    return VIDEO_STEP


def folder_dataset_phase(tmp):
    """Phase 5m (docstring): MultiModalDatasetFolder + UnifiedDataTransform
    on the host."""
    import importlib.util

    from egom2p_torch.data.folder_dataset import MultiModalDatasetFolder
    from egom2p_torch.data.modality_transforms import (DepthTransform,
                                                       PreTokenizedImageAugmenter,
                                                       UnifiedDataTransform,
                                                       default_modality_transforms)

    print("host packages: PIL " + ("imports" if importlib.util.find_spec("PIL") else "absent")
          + ", cv2 " + ("imports" if importlib.util.find_spec("cv2") else "absent"))
    rng = np.random.default_rng(20)
    root = os.path.join(tmp, "folder")
    h, w = FOLDER_SOURCE
    for c in range(FOLDER_CLASSES):
        for i in range(FOLDER_PER_CLASS):
            for mod, arr in (
                    ("rgb", rng.integers(0, 256, (h, w, 3), dtype=np.uint8)),
                    ("depth", rng.integers(0, 65536, (h, w), dtype=np.uint16)),
                    ("tok_rgb", rng.integers(0, 64000, (4, 5, 32, 32)).astype(np.int16)),
                    ("crop_settings", np.stack([
                        [t, l, s, s, f] for t, l, s, f in zip(
                            rng.integers(0, h - 200, 4), rng.integers(0, w - 200, 4),
                            rng.integers(160, 200, 4), rng.integers(0, 2, 4))]))):
                d = os.path.join(root, mod, f"class_{c}")
                os.makedirs(d, exist_ok=True)
                np.save(os.path.join(d, f"s{i:03d}.npy"), arr)
    transforms = default_modality_transforms()
    transforms["depth"] = DepthTransform()
    ds = MultiModalDatasetFolder(
        root, ["rgb", "depth", "tok_rgb", "crop_settings"], modality_transforms=transforms,
        transform=UnifiedDataTransform(transforms, PreTokenizedImageAugmenter(FOLDER_SIZE)),
        return_path=True)
    t0 = time.perf_counter()
    samples = [ds[i] for i in range(len(ds))]
    secs = time.perf_counter() - t0
    s = FOLDER_SIZE
    for smp in samples:
        if (smp["rgb"].shape != (s, s, 3) or smp["depth"].shape != (s, s, 1)
                or smp["tok_rgb"].shape != (5, 32, 32) or smp["rgb"].dtype != np.float32
                or not np.isfinite(smp["depth"]).all()):
            raise AssertionError(f"folder sample {[(k, getattr(v, 'shape', v)) for k, v in smp.items()]}")
    rate = len(samples) / secs
    print(f"folder dataset: {len(samples)} samples of rgb {FOLDER_SOURCE} uint8, depth uint16 "
          f"and 4 stored crops of 5 x 32 x 32 tokens (.npy), a stored crop resized to "
          f"{s}^2 each, in {secs:.2f} s: {rate:.1f} samples/s on the host, one process")


def _demangled(names):
    """{mangled: demangled} by the toolkit's cu++filt (the mangled name where
    it is missing)."""
    from egom2p_torch.ops import _build
    filt = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    names = list(names)
    if not names or not os.path.exists(filt):
        return {n: n for n in names}
    out = subprocess.run([filt, *names], capture_output=True, text=True, check=True).stdout
    def short(line):  # "void ns::kernel<(bool)1, 64>(args)" -> "kernel<1, 64>"
        line = line.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
        line = line.replace("(bool)", "").replace("(int)", "").replace("void ", "")
        return line.split(">(")[0] + ">" if ">(" in line else line.split("(")[0]

    return dict(zip(names, map(short, out.splitlines())))


def check_build(ptxas_log: str, library) -> None:
    """Prints ptxas's registers, spills and remarks per kernel instance, and
    the count of wgmma (HGMMA) instructions in the SASS of the attention
    kernels (forward, dq, dk/dv and fused, at head_dim 64 and 80) and the CE
    forward.  Raises if an instance of these spills, if ptxas says it
    serialises its wgmma
    (C7512, C7515, C7520: "Potential Performance Loss"), or if its SASS holds
    no HGMMA."""
    entry, faults, remarks, per_entry = "", [], set(), {}
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        if "registers" in line or "spill" in line:
            per_entry.setdefault(entry, []).append(line.strip().replace("ptxas info    : ", ""))
            if (any(k in entry for k in WGMMA64_INSTANCES) and "spill" in line
                    and "0 bytes spill stores" not in line):
                faults.append(f"{entry}: {line.strip()}")
        if "Potential Performance Loss" in line:
            remarks.add(line.strip()[:300])
            if any(k in line for k in WGMMA64_INSTANCES):
                faults.append(line.strip())
    names = _demangled(per_entry)
    for entry, lines in per_entry.items():
        print(f"  ptxas {names[entry]}: " + "; ".join(lines))
    for line in sorted(remarks):
        print(f"  ptxas remark: {line}")
    from egom2p_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, ""
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif "HGMMA" in line:
                counts[fn] = counts.get(fn, 0) + 1
        by_kernel = lambda key: sorted(v for k, v in counts.items() if key in k)  # noqa: E731
        print(f"  SASS: HGMMA (wgmma) instructions per instance: flash64_fwd_kernel "
              f"{by_kernel('flash64_fwd_kernel')}, flash64_dq_kernel "
              f"{by_kernel('flash64_dq_kernel')}, flash64_dkv_kernel "
              f"{by_kernel('flash64_dkv_kernel')}, flash_ce_fwd_kernel "
              f"{by_kernel('flash_ce_fwd_kernel')}, flash_ce_bwd_kernel "
              f"{by_kernel('flash_ce_bwd_kernel')}")
        for key, want in WGMMA64_INSTANCES.items():
            if len(by_kernel(key)) != want:
                faults.append(f"{len(by_kernel(key))} of the {want} {key} instances hold HGMMA")
    else:
        print("  SASS: cuobjdump not found, wgmma instructions not counted")
    if faults:
        raise AssertionError("kernel build: " + "; ".join(faults))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from egom2p_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds():.2f} s)")
    check_build(_build.ptxas_log(), _build.build())
    global SM_CLOCK_MHZ
    SM_CLOCK_MHZ = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    def phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        print(f"[{fn.__name__}: {time.perf_counter() - t0:.1f} s]")
        return out

    rows, max_err = phase(kernel_phase, dev)
    phase(ragged_phase, dev)
    launches, safemax_launches, _, served = phase(slice_phase, dev)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        evaluated = phase(eval_phase, dev, served, ckpt_dir)
        seq_evaluated = phase(seq_eval_phase, dev, served, ckpt_dir, evaluated["ckpt"])
        phase(host_tools_phase, dev, seq_evaluated["files"], ckpt_dir)
        captioned = phase(caption_serve_phase, dev, served, ckpt_dir)
        multi = phase(multi_guided_phase, dev, served)
        sam_launches = phase(sam_dense_phase, dev, served, ckpt_dir)
        phase(cosmos_serve_phase, dev, ckpt_dir)
        hub = phase(hub_phase, dev, served, ckpt_dir)
    served.clear()  # the training phases need the card's memory
    torch.cuda.empty_cache()
    train_rows = phase(train_kernel_phase, dev)
    ce_rows = phase(ce_phase, dev)
    train_launches, default_ms, first_metrics = phase(train_slice_phase, dev)
    lora = phase(lora_phase, dev, default_ms)
    shard_launches = phase(shard_train_phase, dev, default_ms)
    caption_launches = phase(caption_train_phase, dev)
    remat_launches, large_remat_launches = phase(remat_phase, dev)
    pipeline_launches = phase(tokenizer_pipeline_phase, dev)
    with tempfile.TemporaryDirectory() as image_dir:
        video = phase(video_vqvae_phase, dev, image_dir, train_rows)
        augmented = phase(augmented_video_phase, dev, video)
        phase(folder_dataset_phase, image_dir)
        features = phase(feature_vqvae_phase, dev, image_dir)
        taming = phase(grad_vqvae_phase, dev, image_dir)
    dp_launches = phase(data_parallel_phase, dev, first_metrics, default_ms)
    fsdp_launches, fsdp_step_launches = phase(fsdp_phase, dev, first_metrics, default_ms)
    fused_rows = phase(fused_bwd_phase, dev)
    phase(ragged_bwd_phase, dev)
    ce_bwd_rows = phase(ce_bwd_phase, dev)
    fused_launches, _ = phase(fused_train_phase, dev, default_ms)
    stock_rows = phase(stock_kernel_phase, dev)
    phase(wide_ce_step_phase, dev)
    large_launches, _ = phase(large_train_phase, dev)

    step_case = train_rows[0]  # encoder self-attention 2048^2, key padding, clamp
    errs = lambda *keys: max(r["err"][k] for r in train_rows for k in keys)  # noqa: E731
    stock_errs = lambda *keys: max(r["err"][k] for r in stock_rows for k in keys)  # noqa: E731
    kernels = []

    def add(name, source, replaces, n, err, ms, plain_ms, bound, library_ms, **more):
        kernels.append({"name": name, "route": "cuda", "source": f"egom2p_torch/csrc/{source}",
                        "replaces": f"egom2p_tpu/ops/{replaces}", "launches": n,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
                        **more})

    # rows[0] / rows[1]: the encoder cond 8704^2 call, the hottest, clamp / safemax
    serve_bound = attention_bound_ms(2, B, HEADS, *rows[0]["shape"], 64)
    serve_exp2 = exp2_bound_ms(B, HEADS, *rows[0]["shape"], SM_CLOCK_MHZ)
    add("flash64_fwd", "flash64_fwd.cu", "flash64.py:83", launches, max_err,
        rows[0]["ms"], rows[0]["plain_ms"], serve_bound, rows[0]["library_ms"],
        exp2_bound_ms=serve_exp2,
        eval_launches={**evaluated["launches"], **seq_evaluated["launches"]},
        rgb2cam_b1=seq_evaluated["b1"],
        caption_launches={k: captioned[k] for k in ("rgb2caption", "caption2rgb")},
        ar_cross=captioned["ar_cross"], multi_guided_launches=multi["launches"],
        multi_guided_ms=multi["generate_ms"], rgb224_context_err=multi["rgb224_err"],
        sam_dense_launches=sam_launches, hub_rgb2depth_launches=hub)
    add("flash64_fwd_safemax", "flash64_fwd.cu", "flash64.py:119", safemax_launches, max_err,
        rows[1]["ms"], rows[1]["plain_ms"], serve_bound, rows[1]["library_ms"],
        exp2_bound_ms=serve_exp2)
    # the library's backward computes dq, dk and dv in one call: the split
    # kernels' rows both carry it
    step_lib = step_case["library_ms"]
    # launches on the phase 5b, 5c and 5d paths: the shard run (its steps and
    # evals), the base and the large remat runs, the tokenizer chain's steps
    paths = {part: {"shard_launches": shard_launches[part],
                    "remat_launches": remat_launches[part],
                    "pipeline_launches": pipeline_launches[part],
                    "dp_launches": dp_launches[part],
                    "fsdp_launches": fsdp_launches[part],
                    "fsdp_launches_per_step": fsdp_step_launches[part],
                    "caption_train_launches": caption_launches[BASE_MODEL][part],
                    "causal_train_launches": caption_launches[CAUSAL_MODEL][part],
                    "video_vqvae_launches_per_step": video["launches"][part],
                    "taming_video_vqvae_launches_per_step": taming["launches"][part],
                    "augmented_video_vqvae_launches_per_step": augmented[part],
                    "lora_launches_per_step": lora[part]}
             for part in ("fwd", "dq", "dkv", "ce_fwd")}
    no_mask = video["no_mask"]  # rows 3-5 at the video step's shape, 2048^2 with no mask
    paths["fwd"]["video_no_mask"] = {"ms": no_mask["ms"]["fwd"], "max_abs_err": no_mask["err"]["o"]}
    paths["dq"]["video_no_mask"] = {"ms": no_mask["ms"]["dq"], "max_abs_err": no_mask["err"]["dq"]}
    paths["dkv"]["video_no_mask"] = {"ms": no_mask["ms"]["dkv"],
                                     "max_abs_err": max(no_mask["err"]["dk"], no_mask["err"]["dv"])}
    paths["fwd"]["dinov2_b14_teacher"] = features["dino"]
    for name, src, line, part, keys, products, tensors, lib, more in (
            ("flash64_train_fwd", "flash64_fwd.cu", 69, "fwd", ("o",), 2, (2, 2), step_lib["fwd"],
             {"exp2_bound_ms": exp2_bound_ms(B, HEADS, 2048, 2048, SM_CLOCK_MHZ)}),
            ("flash64_train_dq", "flash64_train.cu", 172, "dq", ("dq",), 3, (3, 2),
             step_lib["bwd"], {"library_computes": "dq, dk and dv"}),
            ("flash64_train_dkv", "flash64_train.cu", 232, "dkv", ("dk", "dv"), 4, (2, 4),
             step_lib["bwd"], {"library_computes": "dq, dk and dv"})):
        add(name, src, f"flash64_train.py:{line}", train_launches[part], errs(*keys),
            step_case["ms"][part], step_case["plain_ms"][part],
            attention_bound_ms(products, B, HEADS, 2048, 2048, 64, *tensors), lib, **more,
            **paths[part])
    add("flash64_train_dqkv", "flash64_train.cu", "flash64_train.py:296",
        fused_launches["dqkv"], max(r["err"] for r in fused_rows),
        fused_rows[0]["ms"], fused_rows[0]["plain_ms"],
        attention_bound_ms(5, B, HEADS, 2048, 2048, 64, 4, 4), step_lib["bwd"])
    # ce_rows[0]: R = 16384, D = 768, every row live; no single PyTorch call
    # computes logsumexp and gold without the logits: matmul_ms is cuBLAS's
    # y @ W^T alone, which writes them
    caption_ce = next(r for r in ce_rows if r["V"] == CAPTION_VOCAB)
    caption_bound = ce_fwd_bound_ms(caption_ce["R"], 768, CAPTION_VOCAB)
    add("flash_ce_fwd", "flash_ce_fwd.cu", "flash_ce.py:76", train_launches["ce_fwd"],
        max(r["err"] for r in ce_rows), ce_rows[0]["ms"], ce_rows[0]["plain_ms"],
        ce_fwd_bound_ms(ce_rows[0]["R"], 768, ce_rows[0]["V"]), None,
        matmul_ms=ce_rows[0]["matmul_ms"], **paths["ce_fwd"],
        caption_head={"R": caption_ce["R"], "V": CAPTION_VOCAB, "D": 768,
                      "max_abs_err": caption_ce["err"], "ms": caption_ce["ms"],
                      "plain_ms": caption_ce["plain_ms"], "bound_ms": caption_bound[0],
                      "bound_by": caption_bound[1], "matmul_ms": caption_ce["matmul_ms"]})
    # no single PyTorch call computes the CE backward: plain_ms is the chunked route
    add("flash_ce_bwd", "flash_ce_bwd.cu", "flash_ce.py:167", fused_launches["ce_bwd"],
        max(r["err"] for r in ce_bwd_rows), ce_bwd_rows[0]["ms"], ce_bwd_rows[0]["plain_ms"],
        ce_bwd_bound_ms(ce_bwd_rows[0]["live_rows"], ce_bwd_rows[0]["R"], 768,
                        ce_bwd_rows[0]["V"]), None)
    # stock_rows[0]: EgoM2P-large's heads of 68, 2048^2, key padding; the
    # bound counts the true head of 68
    # library_ms: scaled_dot_product_attention on the heads zero-padded to 80
    # with the true head's scale (cuDNN can take it); the math path at 68 beside it
    lib = stock_rows[0]["library_ms"]
    add("stock_flash_fwd", "flash64_fwd.cu", "flash_attention.py:93",
        large_launches["stock_fwd"], stock_errs("o"), stock_rows[0]["ms"]["fwd"],
        stock_rows[0]["plain_ms"]["fwd"],
        attention_bound_ms(2, B, LARGE_HEADS, 2048, 2048, LARGE_HD), lib["fwd"],
        library_math_ms=lib["math_fwd"], instance="head_dim 80",
        large_b8_remat_launches=large_remat_launches["stock_fwd"],
        imagebind_h14_teacher=features["imagebind"])
    add("stock_flash_bwd", "flash64_train.cu", "flash_attention.py:93",
        large_launches["stock_bwd"], stock_errs("dq", "dk", "dv"), stock_rows[0]["ms"]["bwd"],
        stock_rows[0]["plain_ms"]["bwd"],
        attention_bound_ms(5, B, LARGE_HEADS, 2048, 2048, LARGE_HD, 4, 4), lib["bwd"],
        library_math_ms=lib["math_bwd"], instance="head_dim 80",
        large_b8_remat_launches=large_remat_launches["stock_bwd"])
    print(f"chip_smoke: {time.perf_counter() - _STARTED:.1f} s from its imports to its result")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--cards"]:
        sys.exit(cards_check(int(sys.argv[2]), "--fsdp" in sys.argv[3:]))
    sys.exit(main())
