"""VQ-VAE tokenizer training, tokenize and reconstruct: the PyTorch port's
entry point, on one device or data-parallel under torchrun.

Port of run_training_vqvae.py (reference: run_training_vqvae.py), with its
flags and defaults, for every domain of the JAX script: cam and gaze
(sequence VQ-VAEs, tokenizers/seq_vqvae.py), rgb and depth (the video
VQ-VAE, tokenizers/video_vqvae.py, on clips of data/video_dataset.py) and
the teacher-feature domains (CLIP-B16, CLIP-L14, DINOv2-B14[-global],
DINOv2-G14[-global], ImageBind-H14[-global]: the feature VQ-VAE,
tokenizers/feature_vqvae.py, on a frozen teacher's features of rgb images,
models/teachers.py).  A --config file's keys become defaults (JSON, or YAML
where PyYAML is installed, core/config.py):

  train:      python -m egom2p_torch.cli.run_training_vqvae \
                  --config cfgs/vqvae/cam.yaml --data_path cam_train.npy
  tokenize:   ... --resume checkpoint-final.pth --tokenize --tokenize_path clip.npy
  reconstruct ... --resume checkpoint-final.pth --tokenize --recon --tokenize_path clip.npy
  evaluate:   ... --resume checkpoint-final.pth --eval_only --eval_data_path cam_val.npy
  video:      ... --domain rgb --num_frames 16 --data_path CLIPS_DIR --use_npy
  features:   ... --config cfgs/vqvae/clip_b16.yaml --data_path images.npy
  gradient:   ... --quantizer_type taming   (or memcodes), on any domain

Training (`run_train`): the data (cam: (N, 60, 4, 4) poses, canonicalized,
or (N, 60, 9); gaze: (N, 60, 3) with a validity channel) is standardized
as the reference's datasets do, and each epoch visits
np.random.default_rng(seed).permutation's batches (N // batch steps).  The
video domains draw batches from VideoClipDataset.iter_batches (a directory
of .mp4, or of .npy (T, H, W, C) uint8 clips with --use_npy; random windows
and the rgb augmentations, the JAX dataset's draws); the feature domains
take np.random.default_rng(seed).permutation's batches of images ((N, H, W,
3) .npy / .npz, uint8 or [-1, 1], or a directory of clips whose first
frames serve) through the frozen teacher (--teacher_ckpt: a local torch
checkpoint of the published tower, else random weights; --teacher_dtype
bf16 by default), whose features are the VQ-VAE's input.  The
video and feature domains expire dead codes below the reference's fixed
2.0 (run_training_vqvae.py:391); --encoder_ckpt warm-starts the video
encoder from a local DiVAE .safetensors file (core/checkpoint.py:
load_divae_encoder_warm_start, no safetensors package needed);
--percept_loss_weight adds the LPIPS perceptual loss to the video domains
(its VGG weights lpips_vgg.npz in EGOM2P_CKPT_DIR).  The
LR is blr * batch / 256 on a cosine schedule with warmup; the optimizer
clips the global norm and applies AdamW with every parameter decayed
(core/optim.py), and --freeze_enc holds the encoder and quant_proj still
after AdamW; --kmeans_init fills the codebook from the first 256
samples' latents; --model_ema keeps an EMA of the weights.
--quantizer_type taming | memcodes swaps the EMA codebook for a gradient
quantizer (tokenizers/seq_vqvae.py:GradVQAutoencoder around the domain's
core, train/vqvae_train.py:make_grad_vqvae_train_step): the codebook is a
parameter, the loss is reconst + --codebook_weight x the quantizer's loss,
and, as in the JAX script, no k-means init and no perceptual term run;
Memcodes draws its gumbel noise from the step's generator (seed + 1).
Its checkpoints hold `core.*` and `quantizer.*` (the JAX tree's names), and
its tokens are flat per sample.  Every
--eval_freq epochs the loss and the metric suite run on the eval set
(--eval_data_path, else the training data; train/vqvae_eval.py), on the
EMA weights too.  Each epoch appends a JSON line to <output_dir>/log.txt.
Checkpoints are the reference's .pth (core/checkpoint.py):
checkpoint-{epoch}.pth every --save_ckpt_freq epochs and
checkpoint-final.pth after the last, holding "model" (the weights and the
codebook buffers, which core/checkpoint.py:load_seq_vqvae_pth reads),
"optimizer", "step", "epoch", "args" and, with --model_ema, "model_ema".
With --auto_resume (the default) and no --resume, a run resumes from the
latest checkpoint in --output_dir (model, optimizer, step, EMA; an EMA is
seeded from the loaded weights where the file holds none); as in the JAX
script, training does not read --resume.

--tokenize writes the int16 tokens of --tokenize_path's clips to
<tokenize_save_path>/token/<stem>-tok.npz (np.savez, `arr_0`), or with
--recon their denormalized reconstruction to <stem>-recon.npy, as the JAX
script does (`tokenize_file` is the step for one file, for a caller that
loads the tokenizer once for many files).  For rgb / depth --tokenize_path
is a directory of clips (one <clip>-tok.npz of (t', h', w') tokens, or
<clip>-recon.npy, each); for a feature domain a file or directory of
images (one <name>-tok.npz of (N, h, w) tokens, or <name>-recon.npy).
Training a video domain ends (and --eval_only of one) writing
<output_dir>/image_logs/ep{epoch}_{gt,recon}.npy of the first clip, and
for rgb also .mp4 where data/video_ingest.py's native library builds
(it needs libav).  Note: the aligner (prepare_aligned_shards.py) keys a file by its name up to the first
`.`, so a user renames <stem>-tok.npz to <stem>.npz to align it with the
video tokens of clip <stem>.

Under torchrun (core/distributed.py: NCCL on cuda:LOCAL_RANK, gloo with
--device cpu) training is the JAX trainer's step on a global batch of
--batch_size x processes rows (run_training_vqvae.py:595-627,
train/vqvae_train.py): every process draws the same permutation and takes
rows [r b, (r + 1) b) of each global batch, the steps per epoch and the LR
(blr x global batch / 256) follow the global batch, the kmeans init and
any resumed state are broadcast from rank 0, and rank 0 alone prints,
evaluates (train/vqvae_eval.py), writes log.txt and writes the checkpoints
(async saves kept).  torchrun: python -m torch.distributed.run
--standalone --nproc_per_node 2 -m egom2p_torch.cli.run_training_vqvae
... .  --eval_only and --tokenize run in one process (rank 0 under
torchrun; the others return at once): one process's numbers and files.

Everything runs on the first CUDA device (--device cuda, the default) and
raises when there is none; --device cpu asks for the CPU.  Checkpoints are
.pth files: the JAX package's orbax directories are not read.  With
--async_save (the default) a periodic checkpoint is written on a background
thread after its state is copied to host memory; the final save blocks.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

def get_args(argv=None):
    from egom2p_torch.core.config import parse_args_with_config, str2bool

    p = argparse.ArgumentParser("VQ-VAE tokenizer training (PyTorch)", allow_abbrev=False)
    p.add_argument("--run_name", default="auto")
    # architecture (reference: cfgs/default/tokenization/vqvae/**.yaml)
    p.add_argument("--encoder_type", default="CamTransformer")
    p.add_argument("--decoder_type", default="CamTransformer")
    p.add_argument("--num_frames", type=int, default=60)
    p.add_argument("--post_mlp", type=str2bool, default=True)
    p.add_argument("--temporal_downsampling", type=int, default=2)
    # the video domains' architecture (tubelet and patch: the ViViT-B layout)
    p.add_argument("--input_size", type=int, default=256)
    p.add_argument("--tubelet_size", type=int, default=2)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--frame_sample_rate", type=int, default=4)
    p.add_argument("--use_npy", action="store_true")
    p.add_argument("--vq_dim", type=int, default=768)
    p.add_argument("--vq_depth", type=int, default=12)
    p.add_argument("--vq_heads", type=int, default=12)
    p.add_argument("--percept_loss_weight", type=float, default=0.0)
    p.add_argument("--percept_loss_type", default="lpips")
    p.add_argument("--image_log_freq", type=int, default=0)
    # quantizer
    p.add_argument("--codebook_size", type=int, default=256)
    p.add_argument("--latent_dim", type=int, default=32)
    p.add_argument("--norm_codes", type=str2bool, default=True)
    p.add_argument("--quantizer_type", default="lucid", choices=["lucid", "taming", "memcodes"])
    p.add_argument("--coef_ema_dead_code", type=float, default=32.0)
    p.add_argument("--code_replacement_policy", default="batch_random")
    p.add_argument("--commitment_weight", type=float, default=1.0)
    p.add_argument("--quantizer_ema_decay", type=float, default=0.99)
    p.add_argument("--kmeans_init", type=str2bool, default=False)
    p.add_argument("--encoder_ckpt", default=None,
                   help="a 4M DiVAE .safetensors file to warm-start the video encoder")
    p.add_argument("--freeze_enc", type=str2bool, default=False)
    # losses
    p.add_argument("--loss_fn", default="mse", choices=["mse", "mse_mask"])
    p.add_argument("--codebook_weight", type=float, default=1.0)
    # training
    p.add_argument("--dtype", default="fp32", help="the tokenizer trains in fp32")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--opt", default="adamw")
    p.add_argument("--opt_betas", type=float, nargs=2, default=[0.9, 0.99])
    p.add_argument("--blr", type=float, default=2.5e-5)
    p.add_argument("--warmup_lr", type=float, default=1e-6)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--clip_grad", type=float, default=1.0)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--save_ckpt_freq", type=int, default=1)
    p.add_argument("--async_save", type=str2bool, default=True,
                   help="periodic checkpoints written on a background thread "
                        "(the final save always blocks)")
    p.add_argument("--seed", type=int, default=0)
    # evaluation (reference: run_training_vqvae.py:778-806, 1296-1419)
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--num_eval_metrics_samples", type=int, default=256)
    p.add_argument("--no_inception", type=str2bool, default=False)
    # ModelEma (reference: run_training_vqvae.py:230-233, 715-724)
    p.add_argument("--model_ema", type=str2bool, default=False)
    p.add_argument("--model_ema_decay", type=float, default=0.9999)
    p.add_argument("--model_ema_update_freq", type=int, default=1)
    # data
    p.add_argument("--domain", default="cam",
                   help="cam | gaze | rgb | depth | a feature domain (CLIP-B16, CLIP-L14, "
                        "DINOv2-B14[-global], DINOv2-G14[-global], ImageBind-H14[-global])")
    p.add_argument("--teacher_ckpt", default=None,
                   help="a local torch checkpoint of the feature teacher; random if unset")
    p.add_argument("--teacher_dtype", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--data_path", default=None,
                   help="npy/npz of training samples; cam: (N,60,4,4) poses or (N,60,9) "
                        "canonicalized; gaze: (N,60,3) with a validity channel")
    p.add_argument("--eval_data_path", default=None)
    p.add_argument("--output_dir", default="output/vqvae")
    p.add_argument("--resume", default=None)
    p.add_argument("--auto_resume", action="store_true", default=True)
    # tokenize / reconstruct (reference: run_training_vqvae.py:808-812)
    p.add_argument("--tokenize", action="store_true")
    p.add_argument("--recon", action="store_true")
    p.add_argument("--tokenize_path", default=None, help="cam / gaze: an .npy / .npz file "
                   "of one clip or of a batch of clips; rgb / depth: a directory of clips; "
                   "feature domains: images")
    p.add_argument("--tokenize_save_path", default="./")
    # logging
    p.add_argument("--log_wandb", action="store_true", default=False)
    p.add_argument("--no_log_wandb", dest="log_wandb", action="store_false")
    p.add_argument("--wandb_project", default="egom2p-tokenizers")
    p.add_argument("--wandb_entity", default=None)
    p.add_argument("--wandb_run_name", default="auto")
    p.add_argument("--print_freq", type=int, default=20)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run; cuda raises when no CUDA device is found")
    # accepted-but-unused reference keys
    for k in ("find_unused_params", "init_weights", "step_eval", "epoch_eval",
              "eval_metrics_freq", "eval_image_log_freq", "num_logged_images",
              "input_size_eval", "imagenet_default_mean_and_std",
              "min_crop_scale", "dtype_percept"):
        p.add_argument(f"--{k}", default=None)
    return parse_args_with_config(p, argv)


SEQ_DOMAINS = ("cam", "gaze")
VIDEO_DOMAINS = ("rgb", "depth")
GRAD_QUANTIZERS = ("taming", "memcodes")


def is_feature_domain(domain: str) -> bool:
    """A teacher-feature domain (models/teachers.py:TEACHER_SPECS,
    reference FEAT_MODALITIES); an unknown domain exits."""
    from egom2p_torch.models.teachers import TEACHER_SPECS
    if domain in VIDEO_DOMAINS or domain in SEQ_DOMAINS:
        return False
    if domain not in TEACHER_SPECS:
        raise SystemExit(f"unknown --domain {domain!r}; expected one of "
                         f"{SEQ_DOMAINS + VIDEO_DOMAINS} or {tuple(TEACHER_SPECS)}")
    return True


def _quantizer_config(args) -> Dict:
    return dict(codebook_size=args.codebook_size, latent_dim=args.latent_dim,
                ema_decay=args.quantizer_ema_decay, commitment_weight=args.commitment_weight,
                kmeans_init=args.kmeans_init, code_replacement_policy=args.code_replacement_policy,
                dim=args.vq_dim, depth=args.vq_depth, num_heads=args.vq_heads)


def seq_config(args) -> Dict:
    """seq_vqvae_from_config's arguments from the flags
    (run_training_vqvae.py:245-257): the dead-code threshold is
    coef_ema_dead_code / codebook_size."""
    return dict(_quantizer_config(args), num_frames=args.num_frames,
                temporal_compress=args.temporal_downsampling,
                threshold_ema_dead_code=args.coef_ema_dead_code / args.codebook_size)


def build_tokenizer(args, device, generator: Optional[torch.Generator] = None):
    """The domain's tokenizer on `device`: random weights from `generator`,
    or zeros to be loaded over (run_training_vqvae.py:build_tokenizer): the
    EMA codebook's, or a gradient quantizer around the domain's core
    (run_training_vqvae.py:build_grad_tokenizer)."""
    if args.quantizer_type not in GRAD_QUANTIZERS:
        return _ema_tokenizer(args, device, generator)
    from egom2p_torch.tokenizers.seq_vqvae import GradVQAutoencoder, GradVQTokenizer
    net = GradVQAutoencoder(_ema_tokenizer(args, device).net, args.quantizer_type,
                            args.codebook_size, args.latent_dim).to(device)
    if generator is not None:
        net.init_random_(generator)
    return GradVQTokenizer(net)


def _ema_tokenizer(args, device, generator: Optional[torch.Generator] = None):
    """The domain's EMA-codebook tokenizer, the core a gradient quantizer
    wraps (the video and feature domains take the fixed dead-code threshold
    2.0, reference run_training_vqvae.py:391)."""
    if args.domain in SEQ_DOMAINS:
        from egom2p_torch.tokenizers.seq_vqvae import seq_vqvae_from_config
        return seq_vqvae_from_config(args.domain, generator, device=device, **seq_config(args))
    kw = dict(_quantizer_config(args), threshold_ema_dead_code=2.0, norm_codes=args.norm_codes,
              device=device)
    if args.domain in VIDEO_DOMAINS:
        from egom2p_torch.tokenizers.video_vqvae import video_vqvae_from_config
        return video_vqvae_from_config(args.domain, generator, num_frames=args.num_frames,
                                       image_size=args.input_size, tubelet_t=args.tubelet_size,
                                       patch_size=args.patch_size, **kw)
    from egom2p_torch.tokenizers.feature_vqvae import feature_vqvae_from_config
    return feature_vqvae_from_config(args.domain, generator, **kw)


def _pth(path: str) -> str:
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: the port reads .pth checkpoints, not the JAX "
                         "package's orbax checkpoint directories")
    return path


def load_tokenizer_state(args, path: str, device):
    """The tokenizer of a .pth (a trainer checkpoint or the reference's
    {"model": state_dict}) at the flags' widths, on `device`."""
    if args.domain in SEQ_DOMAINS and args.quantizer_type not in GRAD_QUANTIZERS:
        from egom2p_torch.core.checkpoint import load_seq_vqvae_pth
        return load_seq_vqvae_pth(_pth(path), args.domain, device, **seq_config(args))
    from egom2p_torch.core.checkpoint import load_vqvae_pth
    return load_vqvae_pth(_pth(path), build_tokenizer(args, device), f"{args.domain} tokenizer")


def video_dataset(args, path: str, mode: str, seed: int = 0):
    """The clips of `path` (a directory, or one file) in `mode` (train /
    val / tokenize) at the flags' clip length and crop."""
    from egom2p_torch.data.video_dataset import VideoClipDataset
    return VideoClipDataset(path, mode=mode, clip_len=args.num_frames, crop_size=args.input_size,
                            frame_sample_rate=args.frame_sample_rate, domain=args.domain,
                            use_npy=args.use_npy, seed=seed)


class _FrameView:
    """The first frame of each clip of a clip dataset: the feature domains
    train on images (the reference feeds image batches,
    run_training_vqvae.py:949-951)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[int(i)][0]


def load_image_data(args, path: str):
    """rgb images of a feature domain: an .npy / .npz of (N, H, W, 3),
    uint8 or [-1, 1] float, or a directory of clips (or one mp4) whose
    frames serve as images.  The teacher resizes to its own input size."""
    from egom2p_torch.data.video_dataset import VideoClipDataset
    if os.path.isdir(path) or path.endswith((".mp4", ".MP4")):
        return _FrameView(VideoClipDataset(
            path, mode="train", clip_len=1, crop_size=args.input_size,
            frame_sample_rate=args.frame_sample_rate, domain="rgb", use_npy=args.use_npy,
            seed=args.seed))
    data = np.load(path)
    if hasattr(data, "files"):
        data = data[data.files[0]]
    if data.dtype == np.uint8:
        data = data.astype(np.float32) / 127.5 - 1.0
    return data.astype(np.float32)


def build_teacher(args, device):
    """The frozen feature teacher as an extractor (run_training_vqvae.py:
    build_teacher; reference get_feature_extractor, run_training_vqvae.py:
    460-481, 949-1002): images (B, H, W, 3) in [-1, 1], numpy or a tensor
    -> fp32 features (B, h, w, d) on `device`, computed in --teacher_dtype
    (bf16 by default: the tower only infers).  Returns (fn, spec)."""
    from egom2p_torch.models.teachers import get_feature_extractor

    teacher, spec = get_feature_extractor(args.domain, args.teacher_ckpt,
                                          torch.Generator(device).manual_seed(args.seed), device)
    dtype = torch.bfloat16 if args.teacher_dtype == "bf16" else torch.float32
    teacher = teacher.to(dtype)

    @torch.no_grad()
    def feat_fn(rgb):
        return teacher(torch.as_tensor(rgb).to(device, dtype)).float()

    return feat_fn, spec


def _image_batch(images, idx) -> np.ndarray:
    if isinstance(images, np.ndarray):
        return images[idx]
    return np.stack([images[int(j)] for j in idx])


def extract_features(feat_fn, images, batch_size: int, limit=None) -> np.ndarray:
    """Teacher features (N, h, w, d) of a host image collection, batch by batch."""
    n = len(images) if limit is None else min(len(images), limit)
    return np.concatenate([feat_fn(_image_batch(images, np.arange(i, min(i + batch_size, n))))
                           .cpu().numpy() for i in range(0, n, batch_size)])


def prepare_samples(args, path: str):
    """A tokenize / recon input, preprocessed as the reference's datasets
    do (cam_traj_dataset.py:59-63, gaze_dataset.py:105-110), and its output
    name (<stem>-tok or <stem>-recon)."""
    from egom2p_torch.data.cam_gaze import canonicalize_cam, convert_gaze, normalize_cam
    data = np.load(path)
    if hasattr(data, "files"):
        data = data[data.files[0]]
    name = os.path.basename(path).split(".")[0]
    name += "-recon" if args.recon else "-tok"
    if args.domain == "cam":
        if data.ndim == 3 and data.shape[-2:] == (4, 4):
            data = canonicalize_cam(data)
        elif data.ndim == 4 and data.shape[-2:] == (4, 4):
            data = np.stack([canonicalize_cam(d) for d in data])
        x = normalize_cam(data).astype(np.float32)
    else:
        if data.shape[-1] == 2:
            # holoassist example params (reference: gaze_dataset.py:105-110)
            data = convert_gaze(data, orig_res=[896, 504], resize_res=[896, 504],
                                new_res=[480, 480])
        x = data.astype(np.float32)
    if x.ndim == 2:  # one clip (T, C) -> a batch of one; (N, T, C) stays
        x = x[None]
    return x, name


def load_seq_data(args, path: str) -> np.ndarray:
    """A cam / gaze training or eval set, canonicalized and standardized
    (reference: cam_traj_dataset.py:156-182)."""
    from egom2p_torch.data.cam_gaze import canonicalize_cam, normalize_cam
    data = np.load(path)
    if hasattr(data, "files"):
        data = data[data.files[0]]
    if args.domain == "cam" and data.ndim == 4:
        data = np.stack([canonicalize_cam(d) for d in data])
    if args.domain == "cam":
        data = normalize_cam(data)
    return data.astype(np.float32)


def build_eval_data(args, fallback=None, feat_fn=None):
    """The eval set of --eval_data_path, else `fallback` (the training
    data, or for the video domains the training clip dataset): val-mode
    clips for rgb / depth, teacher features for a feature domain."""
    if args.domain in VIDEO_DOMAINS:
        return video_dataset(args, args.eval_data_path, "val") if args.eval_data_path else fallback
    if is_feature_domain(args.domain):
        images = load_image_data(args, args.eval_data_path) if args.eval_data_path else fallback
        if images is None:
            return None
        return extract_features(feat_fn, images, args.batch_size,
                                limit=args.num_eval_metrics_samples)
    return load_seq_data(args, args.eval_data_path) if args.eval_data_path else fallback


def tokenize_file(args, tok, path: str) -> str:
    """The tokens or, with --recon, the denormalized reconstruction of the
    clips of one .npy / .npz file, written under <tokenize_save_path>/token.
    Returns the path written."""
    from egom2p_torch.data.cam_gaze import denormalize_cam, denormalize_gaze

    x, name = prepare_samples(args, path)
    out_dir = os.path.join(args.tokenize_save_path, "token")
    os.makedirs(out_dir, exist_ok=True)
    if args.recon:
        rec = tok.autoencode(x).cpu().numpy()
        rec = rec[0] if rec.shape[0] == 1 else rec
        out = os.path.join(out_dir, f"{name}.npy")
        np.save(out, denormalize_cam(rec) if args.domain == "cam" else denormalize_gaze(rec))
    else:
        tokens = tok.tokenize(x).cpu().numpy().astype(np.int16)
        out = os.path.join(out_dir, f"{name}.npz")
        np.savez(out, tokens[0] if tokens.shape[0] == 1 else tokens)
    print(f"saved {out}")
    return out


def _write_clip_mp4(path: str, clip: np.ndarray) -> bool:
    """An rgb clip in [-1, 1] as an 8 fps mp4 through data/video_ingest.py;
    False (and a note) where its native library does not build or load
    (no libav)."""
    from egom2p_torch.data import video_ingest
    from egom2p_torch.tokenizers.cosmos.video_api import tensor2numpy
    try:
        video_ingest.write_video(path, tensor2numpy(clip), fps=8.0)
        return True
    except (RuntimeError, OSError) as e:
        print(f"[note] {path} not written: {str(e).splitlines()[0]}")
        return False


def run_tokenize_video(args, tok):
    """--tokenize of a directory of clips (reference VideoDataset 'tokenize'
    mode, video_dataset.py:165-167, run_training_vqvae.py:1771-1816): one
    <clip>-tok.npz of (t', h', w') int16 tokens each, or with --recon
    <clip>-recon.npy (and for rgb <clip>-recon.mp4).  Returns the paths."""
    ds = video_dataset(args, args.tokenize_path, "tokenize")
    out_dir = os.path.join(args.tokenize_save_path, "token")
    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for i in range(len(ds)):
        clip = ds[i][None]
        name = os.path.splitext(os.path.basename(ds.samples[i]))[0]
        if args.recon:
            rec = tok.autoencode(clip).cpu().numpy()[0]
            out = os.path.join(out_dir, f"{name}-recon.npy")
            np.save(out, rec)
            if args.domain == "rgb":
                _write_clip_mp4(os.path.join(out_dir, f"{name}-recon.mp4"), rec)
        else:
            out = os.path.join(out_dir, f"{name}-tok.npz")
            np.savez(out, tok.tokenize(clip).cpu().numpy()[0].astype(np.int16))
        outs.append(out)
        print(f"saved {out}")
    return outs


def run_tokenize_features(args, tok) -> str:
    """--tokenize of images into teacher-feature tokens (the artifacts the
    pretraining registry reads as tok_clip@224, tok_dinov2@224, ...;
    reference modality_info.py:194-205): one <name>-tok.npz of (N, h, w)
    int16 tokens, or with --recon <name>-recon.npy of the reconstructed
    features.  Returns the path written."""
    feat_fn, _ = build_teacher(args, tok.device)
    feats = extract_features(feat_fn, load_image_data(args, args.tokenize_path), args.batch_size)
    name = os.path.basename(os.path.normpath(args.tokenize_path)).split(".")[0]
    name += "-recon" if args.recon else "-tok"
    out_dir = os.path.join(args.tokenize_save_path, "token")
    os.makedirs(out_dir, exist_ok=True)
    chunks = [feats[i:i + args.batch_size] for i in range(0, len(feats), args.batch_size)]
    if args.recon:
        out = os.path.join(out_dir, f"{name}.npy")
        np.save(out, np.concatenate([tok.autoencode(c).cpu().numpy() for c in chunks]))
    else:
        out = os.path.join(out_dir, f"{name}.npz")
        np.savez(out, np.concatenate([tok.tokenize(c).cpu().numpy() for c in chunks])
                 .astype(np.int16))
    print(f"saved {out}")
    return out


def run_tokenize(args):
    """--tokenize (run_training_vqvae.py:366-399) of --tokenize_path with
    the tokenizer of --resume.  Returns the path (the video domains: the
    paths) written."""
    from egom2p_torch.cli.eval_common import resolve_device

    device = resolve_device(args.device)
    if args.resume:
        tok = load_tokenizer_state(args, args.resume, device)
    else:
        print("[warn] --tokenize without --resume: random weights")
        tok = build_tokenizer(args, device, torch.Generator(device).manual_seed(args.seed))
    if args.domain in VIDEO_DOMAINS:
        return run_tokenize_video(args, tok)
    if is_feature_domain(args.domain):
        return run_tokenize_features(args, tok)
    return tokenize_file(args, tok, args.tokenize_path)


def eval_image_log(args, tok, epoch, dataset) -> list:
    """The first clip of `dataset` and its reconstruction as
    <output_dir>/image_logs/ep{epoch}_{gt,recon}.npy, and for rgb .mp4 where
    the native video library builds (reference: run_training_vqvae.py:
    1818-1970).  Returns the paths written."""
    out_dir = os.path.join(args.output_dir, "image_logs")
    os.makedirs(out_dir, exist_ok=True)
    gt = dataset[0][None]
    rec = tok.autoencode(gt).cpu().numpy()[0]
    paths = []
    for tag, clip in (("gt", gt[0]), ("recon", rec)):
        path = os.path.join(out_dir, f"ep{epoch}_{tag}")
        np.save(path + ".npy", clip)
        paths.append(path + ".npy")
        if args.domain == "rgb" and _write_clip_mp4(path + ".mp4", clip):
            paths.append(path + ".mp4")
    print(f"image log: {paths}")
    return paths


def _ema_state(net, ema) -> Dict[str, torch.Tensor]:
    """The EMA model's state dict: the EMA weights and the live codebook
    buffers (the JAX package evaluates EMA weights with the live codebook)."""
    return {k: (ema[k] if k in ema else v) for k, v in net.state_dict().items()}


def _resume(args, net, optimizer):
    """(step, checkpoint) from the latest checkpoint in --output_dir under
    --auto_resume without --resume (run_training_vqvae.py:692); (0, None)
    otherwise or where there is none."""
    from egom2p_torch.core.checkpoint import latest_checkpoint, load_pth
    path = (latest_checkpoint(args.output_dir) if args.auto_resume and not args.resume
            else None)
    if path is None:
        return 0, None
    ckpt = load_pth(_pth(path))
    net.load_state_dict(ckpt["model"])
    if "optimizer" in ckpt:
        optimizer.load_state_dict(ckpt["optimizer"])
    print(f"resumed from {path} at step {ckpt.get('step', 0)}")
    return int(ckpt.get("step", 0)), ckpt


def run_train(args, on_step: Optional[Callable[[int, Dict[str, float], float], None]] = None):
    """Train (run_training_vqvae.py:583-751).  `on_step(step, metrics,
    seconds)` runs after every step; `seconds` is the step's wall time
    from a device synchronization to its metrics on the host.  Returns {"tokenizer",
    "optimizer", "ema", "step_seconds", "metrics"}."""
    from egom2p_torch.cli.eval_common import resolve_device
    from egom2p_torch.core import distributed
    from egom2p_torch.core.checkpoint import save_checkpoint, wait_for_saves
    from egom2p_torch.core.logging import JsonlLogger, MetricLogger
    from egom2p_torch.core.optim import Optimizer, freeze_masked, freeze_modules_mask
    from egom2p_torch.core.schedules import cosine_scheduler
    from egom2p_torch.ops.vq import kmeans_init_state
    from egom2p_torch.train.vqvae_eval import run_eval_suite
    from egom2p_torch.train.vqvae_train import (init_ema, make_grad_vqvae_train_step,
                                                make_vqvae_train_step)

    if not args.data_path:
        raise ValueError("--data_path is required for training")
    device = resolve_device(args.device)
    distributed.init_distributed_mode(device.type)
    if device.type == "cuda":
        device = torch.device("cuda", distributed.local_rank())
    world, rank = distributed.world_size(), distributed.rank()
    video_domain, feat_domain = args.domain in VIDEO_DOMAINS, is_feature_domain(args.domain)
    dataset = data = feat_fn = None
    if video_domain:
        dataset = video_dataset(args, args.data_path, "train", seed=args.seed)
        n_samples = len(dataset)
        print(f"train videos: {n_samples}")
    elif feat_domain:
        data = load_image_data(args, args.data_path)
        n_samples = len(data)
        feat_fn, _ = build_teacher(args, device)
        print(f"train images: {n_samples} ({args.domain} features)")
    else:
        data = load_seq_data(args, args.data_path)
        n_samples = len(data)
        print(f"train samples: {data.shape}")
    tok = build_tokenizer(args, device, torch.Generator(device).manual_seed(args.seed))
    net = tok.net
    grad_vq = args.quantizer_type in GRAD_QUANTIZERS
    if args.encoder_ckpt:
        if not video_domain:
            raise ValueError("--encoder_ckpt warm-starts the video (rgb / depth) encoder")
        from egom2p_torch.core.checkpoint import load_divae_encoder_warm_start
        load_divae_encoder_warm_start(args.encoder_ckpt, net.core if grad_vq else net)
    batch_size = args.batch_size
    global_batch = batch_size * world
    niter_per_ep = max(n_samples // global_batch, 1)
    print(f"device {device}, {world} process(es), global batch {global_batch}, "
          f"{niter_per_ep} steps per epoch")
    sched = cosine_scheduler(args.blr * global_batch / 256.0, args.min_lr, args.epochs,
                             niter_per_ep, warmup_epochs=args.warmup_epochs,
                             start_warmup_value=args.warmup_lr)
    optimizer = Optimizer(net, sched, weight_decay=args.weight_decay,
                          betas=tuple(args.opt_betas), clip_grad=args.clip_grad, decay_all=True)
    if args.freeze_enc:
        freeze_masked(freeze_modules_mask(net, ("encoder", "quant_proj")), optimizer, net)
    ema_decay = args.model_ema_decay if args.model_ema else None
    if args.model_ema:
        print(f"Using EMA with decay = {args.model_ema_decay:.8f}")
    percept = None
    if video_domain and args.percept_loss_weight > 0.0 and not grad_vq:
        from egom2p_torch.core.image_metrics import make_perceptual_loss
        percept = make_perceptual_loss(args.percept_loss_type, device)
    if args.kmeans_init and not grad_vq and not bool(net.quantize.state.initted.all()):
        # the data-dependent codebook init, once before training (the
        # reference does it lazily in the first forward, quantize_lucid.py:137-167)
        if video_domain:
            first = torch.from_numpy(dataset[0][None])
        elif feat_domain:
            first = torch.from_numpy(extract_features(feat_fn, data, args.batch_size,
                                                      limit=min(n_samples, 64)))
        else:
            first = torch.from_numpy(data[:min(n_samples, 256)])
        with torch.no_grad():
            lat = net.encode_latents(first.to(device))
        net.quantize.set_state(kmeans_init_state(
            net.quantize.cfg, lat, generator=torch.Generator(device).manual_seed(args.seed + 1)))
        print("kmeans codebook init from the first batch")
    step, ckpt = _resume(args, net, optimizer)
    # every process starts from rank 0's weights and codebook
    distributed.broadcast_module_(net)
    ema = init_ema(net) if args.model_ema else None
    if ckpt is not None and ema is not None:
        # a checkpoint without an EMA seeds it from the loaded weights
        # (run_training_vqvae.py:573-580)
        ema = ({k: v.to(device) for k, v in ckpt["model_ema"].items() if k in ema}
               if "model_ema" in ckpt else init_ema(net))
    start_epoch = step // niter_per_ep
    if grad_vq:
        step_fn = make_grad_vqvae_train_step(net, optimizer, args.loss_fn, args.codebook_weight,
                                             ema=ema, ema_decay=ema_decay,
                                             ema_update_freq=args.model_ema_update_freq)
    else:
        step_fn = make_vqvae_train_step(net, optimizer, args.loss_fn, args.codebook_weight,
                                        ema=ema, ema_decay=ema_decay,
                                        ema_update_freq=args.model_ema_update_freq,
                                        percept_loss=percept,
                                        percept_weight=args.percept_loss_weight)

    rng = np.random.default_rng(args.seed)
    # expired codes' replacements, or Memcodes' gumbel noise
    draws = torch.Generator(device).manual_seed(args.seed + 1)
    jsonl = JsonlLogger(args.output_dir)
    # the eval data is the same every epoch: built once
    eval_data = (build_eval_data(args, fallback=dataset if video_domain else data,
                                 feat_fn=feat_fn) if args.eval_freq else None)
    batch_iter = dataset.iter_batches(global_batch) if video_domain else None
    step_seconds, history = [], []
    for epoch in range(start_epoch, args.epochs):
        logger = MetricLogger(print_freq=args.print_freq)
        order = None if video_domain else rng.permutation(n_samples)
        for it, _ in logger.log_every(range(niter_per_ep), header=f"Epoch [{epoch}]",
                                      total=niter_per_ep):
            # this process's rows of the global batch; the video and image
            # datasets' augmentations draw in sample order, so every process
            # draws the whole global batch (one process's stream)
            lo = rank * batch_size
            if video_domain:
                batch = next(batch_iter)
            elif feat_domain:
                batch = _image_batch(data, order[it * global_batch:(it + 1) * global_batch])
            else:
                batch = data[order[it * global_batch + lo:it * global_batch + lo + batch_size]]
            if batch.shape[0] > batch_size:
                batch = batch[lo:lo + batch_size]
            batch = torch.from_numpy(np.ascontiguousarray(batch))
            batch = batch.to(device)
            if feat_domain:  # the frozen teacher's features, on the device
                batch = feat_fn(batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            metrics = step_fn(batch, generator=draws)
            values = {k: float(v) for k, v in metrics.items()}
            seconds = time.perf_counter() - t0
            logger.update(**values)
            step_seconds.append(seconds)
            history.append(values)
            if on_step is not None:
                on_step(step, values, seconds)
            step += 1
        epoch_stats = {"epoch": epoch, **{k: v.global_avg for k, v in logger.meters.items()}}
        if args.eval_freq and (epoch + 1) % args.eval_freq == 0:
            eval_stats = run_eval_suite(tok, eval_data, args.domain, args.codebook_size,
                                        args.loss_fn, args.codebook_weight, batch_size,
                                        limit=args.num_eval_metrics_samples, ema=ema,
                                        no_inception=args.no_inception)
            print(f"[Eval] epoch {epoch}: "
                  + "  ".join(f"{k}={v:.6g}" for k, v in eval_stats.items()))
            epoch_stats.update({k if k.startswith(("eval_", "ema_")) else f"eval_{k}": v
                                for k, v in eval_stats.items()})
        jsonl.write(epoch_stats)
        if (epoch + 1) % args.save_ckpt_freq == 0 or epoch == args.epochs - 1:
            extra = {} if ema is None else {"model_ema": _ema_state(net, ema)}
            final = epoch == args.epochs - 1
            blocking = final or not args.async_save
            path = save_checkpoint(args.output_dir, "final" if final else epoch, net,
                                   optimizer, step=step, epoch=epoch, args=args,
                                   blocking=blocking, write=distributed.is_main_process(),
                                   **extra)
            print(f"saved{'' if blocking else ' (async)'} {path}")
        if video_domain and distributed.is_main_process() and (
                epoch == args.epochs - 1
                or (args.image_log_freq and (epoch + 1) % args.image_log_freq == 0)):
            eval_image_log(args, tok, epoch, dataset)
        if video_domain and world > 1:
            # rank 0's eval and image log drew from the shared clip stream:
            # every process continues from its generator's state
            state = distributed.broadcast_object(dataset.rng.bit_generator.state)
            dataset.rng.bit_generator.state = state
    wait_for_saves()
    distributed.barrier()  # the files are on disk before any process reads them
    return {"tokenizer": tok, "optimizer": optimizer, "ema": ema,
            "step_seconds": step_seconds, "metrics": history}


def run_eval_only(args) -> Dict[str, float]:
    """Evaluate a checkpoint and write <output_dir>/eval_results.json
    (run_training_vqvae.py:754-807; a video domain also logs its first
    clip, eval_image_log)."""
    from egom2p_torch.cli.eval_common import resolve_device
    from egom2p_torch.core.checkpoint import latest_checkpoint
    from egom2p_torch.train.vqvae_eval import eval_metrics, evaluate_loss

    device = resolve_device(args.device)
    path = args.resume or latest_checkpoint(args.output_dir)
    if not path:
        raise ValueError("--eval_only needs --resume or checkpoints in --output_dir")
    tok = load_tokenizer_state(args, path, device)
    eval_path = args.eval_data_path or args.data_path or args.tokenize_path
    if not eval_path:
        raise ValueError("--eval_only needs --eval_data_path (or --data_path)")
    if args.domain in VIDEO_DOMAINS:
        eval_data = video_dataset(args, eval_path, "val")
    elif is_feature_domain(args.domain):
        feat_fn, _ = build_teacher(args, device)
        eval_data = extract_features(feat_fn, load_image_data(args, eval_path), args.batch_size,
                                     limit=args.num_eval_metrics_samples)
    else:
        eval_data = load_seq_data(args, eval_path)
    results = evaluate_loss(tok, eval_data, args.loss_fn, args.codebook_weight, args.batch_size,
                            tok.net.n_channels, limit=args.num_eval_metrics_samples)
    results.update(eval_metrics(tok, eval_data, args.domain, args.codebook_size,
                                args.batch_size, limit=args.num_eval_metrics_samples,
                                no_inception=args.no_inception))
    print("[Eval only] " + "  ".join(f"{k}={v:.6g}" for k, v in results.items()))
    if args.domain in VIDEO_DOMAINS and len(eval_data):
        eval_image_log(args, tok, "eval", eval_data)
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "eval_results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"saved {out}")
    return results


def main(argv=None, **kwargs):
    """Parse `argv` and run --eval_only, --tokenize or training (`kwargs`
    go to run_train)."""
    from egom2p_torch.core import distributed

    args = get_args(argv)
    is_feature_domain(args.domain)  # an unknown domain exits
    if args.eval_only or args.tokenize:
        if int(os.environ.get("RANK", "0")) != 0:
            return None  # one process's numbers and files: rank 0's
        return run_eval_only(args) if args.eval_only else run_tokenize(args)
    from egom2p_torch.cli.eval_common import resolve_device
    distributed.init_distributed_mode(resolve_device(args.device).type)
    with distributed.main_prints_only():
        return run_train(args, **kwargs)


if __name__ == "__main__":
    main()
