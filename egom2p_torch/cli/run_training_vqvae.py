"""Cam / gaze VQ-VAE tokenizer training, tokenize and reconstruct: the
PyTorch port's entry point, on one device.

Port of run_training_vqvae.py's cam / gaze branches (reference:
run_training_vqvae.py), with its flags and defaults; a --config file's keys
become defaults (JSON, or YAML where PyYAML is installed, core/config.py):

  train:      python -m egom2p_torch.cli.run_training_vqvae \
                  --config cfgs/vqvae/cam.yaml --data_path cam_train.npy
  tokenize:   ... --resume checkpoint-final.pth --tokenize --tokenize_path clip.npy
  reconstruct ... --resume checkpoint-final.pth --tokenize --recon --tokenize_path clip.npy
  evaluate:   ... --resume checkpoint-final.pth --eval_only --eval_data_path cam_val.npy

Training (`run_train`): the data (cam: (N, 60, 4, 4) poses, canonicalized,
or (N, 60, 9); gaze: (N, 60, 3) with a validity channel) is standardized
as the reference's datasets do, and each epoch visits
np.random.default_rng(seed).permutation's batches (N // batch steps); the
LR is blr * batch / 256 on a cosine schedule with warmup; the optimizer
clips the global norm and applies AdamW with every parameter decayed
(core/optim.py), and --freeze_enc holds the encoder and quant_proj still
after AdamW; --kmeans_init fills the codebook from the first 256
samples' latents; --model_ema keeps an EMA of the weights.  Every
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
loads the tokenizer once for many files).  Note: the aligner (prepare_aligned_shards.py) keys a file by its name up to the first
`.`, so a user renames <stem>-tok.npz to <stem>.npz to align it with the
video tokens of clip <stem>.

Everything runs on the first CUDA device (--device cuda, the default) and
raises when there is none; --device cpu asks for the CPU.  Checkpoints are
.pth files: the JAX package's orbax directories are not read.  With
--async_save (the default) a periodic checkpoint is written on a background
thread after its state is copied to host memory; the final save blocks.
Not ported yet (ROADMAP Queue 1 item 9): the video and feature domains, the gradient quantizers
(--quantizer_type taming / memcodes) and --encoder_ckpt; each raises.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

ITEM_9 = "not ported yet (ROADMAP Queue 1 item 9)"


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
    # the video domains' architecture: accepted, those domains raise
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
    p.add_argument("--encoder_ckpt", default=None, help=f"video encoder warm start: {ITEM_9}")
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
    p.add_argument("--domain", default="cam", help="cam | gaze (the others are "
                   f"{ITEM_9})")
    p.add_argument("--teacher_ckpt", default=None)
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
    p.add_argument("--tokenize_path", default=None, help="an .npy / .npz file of one clip "
                   "or of a batch of clips")
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


def check_ported(args) -> None:
    """What this entry point does not run yet raises, naming the item."""
    from egom2p_torch.train.vqvae_eval import SEQ_DOMAINS
    if args.domain not in SEQ_DOMAINS:
        raise NotImplementedError(f"--domain {args.domain}: the video and feature domains are "
                                  f"{ITEM_9}")
    if args.quantizer_type != "lucid":
        raise NotImplementedError(f"--quantizer_type {args.quantizer_type}: the gradient "
                                  f"quantizers are {ITEM_9}")
    if args.encoder_ckpt:
        raise NotImplementedError(f"--encoder_ckpt (a DiVAE warm start of the video encoder) "
                                  f"is {ITEM_9}")


def seq_config(args) -> Dict:
    """seq_vqvae_from_config's arguments from the flags
    (run_training_vqvae.py:245-257): the dead-code threshold is
    coef_ema_dead_code / codebook_size."""
    return dict(num_frames=args.num_frames, temporal_compress=args.temporal_downsampling,
                codebook_size=args.codebook_size, latent_dim=args.latent_dim,
                ema_decay=args.quantizer_ema_decay,
                threshold_ema_dead_code=args.coef_ema_dead_code / args.codebook_size,
                commitment_weight=args.commitment_weight, kmeans_init=args.kmeans_init,
                code_replacement_policy=args.code_replacement_policy,
                dim=args.vq_dim, depth=args.vq_depth, num_heads=args.vq_heads)


def build_tokenizer(args, device, generator: Optional[torch.Generator] = None):
    """The cam or gaze tokenizer on `device`: random weights from
    `generator`, or zeros to be loaded over."""
    from egom2p_torch.tokenizers.seq_vqvae import seq_vqvae_from_config
    return seq_vqvae_from_config(args.domain, generator, device=device, **seq_config(args))


def _pth(path: str) -> str:
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: the port reads .pth checkpoints, not the JAX "
                         "package's orbax checkpoint directories")
    return path


def load_tokenizer_state(args, path: str, device):
    """The tokenizer of a .pth (a trainer checkpoint or the reference's
    {"model": state_dict}) at the flags' widths, on `device`."""
    from egom2p_torch.core.checkpoint import load_seq_vqvae_pth
    return load_seq_vqvae_pth(_pth(path), args.domain, device, **seq_config(args))


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


def build_eval_data(args, fallback=None):
    """The eval set of --eval_data_path, else `fallback` (the training data)."""
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


def run_tokenize(args) -> str:
    """--tokenize (run_training_vqvae.py:366-399) of --tokenize_path with
    the tokenizer of --resume.  Returns the path written."""
    from egom2p_torch.cli.eval_common import resolve_device

    device = resolve_device(args.device)
    if args.resume:
        tok = load_tokenizer_state(args, args.resume, device)
    else:
        print("[warn] --tokenize without --resume: random weights")
        tok = build_tokenizer(args, device, torch.Generator(device).manual_seed(args.seed))
    return tokenize_file(args, tok, args.tokenize_path)


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
    from egom2p_torch.core.checkpoint import save_checkpoint, wait_for_saves
    from egom2p_torch.core.logging import JsonlLogger, MetricLogger
    from egom2p_torch.core.optim import Optimizer, freeze_masked, freeze_modules_mask
    from egom2p_torch.core.schedules import cosine_scheduler
    from egom2p_torch.ops.vq import kmeans_init_state
    from egom2p_torch.train.vqvae_eval import run_eval_suite
    from egom2p_torch.train.vqvae_train import init_ema, make_vqvae_train_step

    if not args.data_path:
        raise ValueError("--data_path is required for training")
    device = resolve_device(args.device)
    data = load_seq_data(args, args.data_path)
    n_samples = len(data)
    print(f"train samples: {data.shape}")
    tok = build_tokenizer(args, device, torch.Generator(device).manual_seed(args.seed))
    net = tok.net
    batch_size = args.batch_size
    niter_per_ep = max(n_samples // batch_size, 1)
    sched = cosine_scheduler(args.blr * batch_size / 256.0, args.min_lr, args.epochs,
                             niter_per_ep, warmup_epochs=args.warmup_epochs,
                             start_warmup_value=args.warmup_lr)
    optimizer = Optimizer(net, sched, weight_decay=args.weight_decay,
                          betas=tuple(args.opt_betas), clip_grad=args.clip_grad, decay_all=True)
    if args.freeze_enc:
        freeze_masked(freeze_modules_mask(net, ("encoder", "quant_proj")), optimizer, net)
    ema_decay = args.model_ema_decay if args.model_ema else None
    if args.model_ema:
        print(f"Using EMA with decay = {args.model_ema_decay:.8f}")
    if args.kmeans_init and not bool(net.quantize.state.initted.all()):
        # the data-dependent codebook init, once before training (the
        # reference does it lazily in the first forward, quantize_lucid.py:137-167)
        with torch.no_grad():
            lat = net.encode_latents(torch.from_numpy(data[:min(n_samples, 256)]).to(device))
        net.quantize.set_state(kmeans_init_state(
            net.quantize.cfg, lat, generator=torch.Generator(device).manual_seed(args.seed + 1)))
        print("kmeans codebook init from the first batch")
    ema = init_ema(net) if args.model_ema else None
    step, ckpt = _resume(args, net, optimizer)
    if ckpt is not None and ema is not None:
        # a checkpoint without an EMA seeds it from the loaded weights
        # (run_training_vqvae.py:573-580)
        ema = ({k: v.to(device) for k, v in ckpt["model_ema"].items() if k in ema}
               if "model_ema" in ckpt else init_ema(net))
    start_epoch = step // niter_per_ep
    step_fn = make_vqvae_train_step(net, optimizer, args.loss_fn, args.codebook_weight,
                                    ema=ema, ema_decay=ema_decay,
                                    ema_update_freq=args.model_ema_update_freq)

    rng = np.random.default_rng(args.seed)
    draws = torch.Generator(device).manual_seed(args.seed + 1)  # expired codes' replacements
    jsonl = JsonlLogger(args.output_dir)
    eval_data = build_eval_data(args, fallback=data) if args.eval_freq else None
    step_seconds, history = [], []
    for epoch in range(start_epoch, args.epochs):
        logger = MetricLogger(print_freq=args.print_freq)
        order = rng.permutation(n_samples)
        for it, _ in logger.log_every(range(niter_per_ep), header=f"Epoch [{epoch}]",
                                      total=niter_per_ep):
            batch = torch.from_numpy(data[order[it * batch_size:(it + 1) * batch_size]])
            batch = batch.to(device)
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
                                        limit=args.num_eval_metrics_samples, ema=ema)
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
                                   blocking=blocking, **extra)
            print(f"saved{'' if blocking else ' (async)'} {path}")
    wait_for_saves()
    return {"tokenizer": tok, "optimizer": optimizer, "ema": ema,
            "step_seconds": step_seconds, "metrics": history}


def run_eval_only(args) -> Dict[str, float]:
    """Evaluate a checkpoint and write <output_dir>/eval_results.json
    (run_training_vqvae.py:754-807)."""
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
    eval_data = load_seq_data(args, eval_path)
    results = evaluate_loss(tok, eval_data, args.loss_fn, args.codebook_weight, args.batch_size,
                            tok.net.encoder.in_channels, limit=args.num_eval_metrics_samples)
    results.update(eval_metrics(tok, eval_data, args.domain, args.codebook_size,
                                args.batch_size, limit=args.num_eval_metrics_samples))
    print("[Eval only] " + "  ".join(f"{k}={v:.6g}" for k, v in results.items()))
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "eval_results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"saved {out}")
    return results


def main(argv=None, **kwargs):
    """Parse `argv` and run --eval_only, --tokenize or training (`kwargs`
    go to run_train)."""
    args = get_args(argv)
    check_ported(args)
    if args.eval_only:
        return run_eval_only(args)
    if args.tokenize:
        return run_tokenize(args)
    return run_train(args, **kwargs)


if __name__ == "__main__":
    main()
