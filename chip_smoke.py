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
   on TF32 and on full fp32: no token may differ.
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
12. Prints the kernel JSON line (per kernel: launches on its main path, max
   error, kernel / plain / library times and the card's bound for the same
   work: the larger of its bytes at 3.35 TB/s and its operations at the
   dense bf16 peak), the card's name and power limit, and last the device
   JSON line.

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


def _fused_views(rng, n_q, n_kv, dev):
    """q as a view of a (B, N, 3C) qkv projection, k/v as views of a
    (B, M, 2C) kv projection, the layouts the model hands the kernel."""
    C = HEADS * 64
    qkv, kv = _randn(rng, (B, n_q, 3 * C), dev), _randn(rng, (B, n_kv, 2 * C), dev)
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
    from egom2p_torch.generate.schedules import build_chained_generation_schedules
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
    schedule = build_chained_generation_schedules(
        cond_domains=["tok_rgb"], target_domains=["tok_depth"],
        tokens_per_target=[5120], autoregression_schemes=["roar"],
        decoding_steps=[3], token_decoding_schedules=["linear"],
        temps=[0.01], temp_schedules=["constant"], cfg_scales=[2.0],
        cfg_schedules=["constant"], cfg_grow_conditioning=True)
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
    head_check(model, sampler, tokens)
    return launches, safemax_launches, B / (tok_ms + gen_ms) * 1e3


def head_check(model, sampler, tokens):
    """Greedy rgb2depth on the served batch twice: with the generation head's
    product on TF32 (forward_logits: bf16 values, exact in TF32) and with the
    full fp32 product.  The tokens must be equal."""
    from egom2p_torch.generate.schedules import build_chained_generation_schedules
    from egom2p_torch.models import embeddings

    schedule = build_chained_generation_schedules(
        cond_domains=["tok_rgb"], target_domains=["tok_depth"], tokens_per_target=[5120],
        autoregression_schemes=["roar"], decoding_steps=[3], token_decoding_schedules=["linear"],
        temps=[0.0], temp_schedules=["constant"], cfg_scales=[2.0], cfg_schedules=["constant"],
        cfg_grow_conditioning=True)
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
# rows and with half the rows live, a vocab its tiles do not divide, the
# wider registry dims, and the split instance at the trainer's B = 1 (R =
# 2048) and the dim-1024 check step's R = 512
CE_FWD_CASES = ((16384, 64000, 768, "all"), (1000, 64007, 768, "all"),
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


def _device_breakdown(prof, what, wall_ms, ref_ms):
    """Prints a trace's device time by kernel class and the device's idle
    share against `ref_ms`, the same work's time without the profiler."""
    spans, by_class = [], {}
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
    kernels = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        loss_p, tok_p, grads_p = run()
    finally:
        for (mod, name, _), kernel in zip(swaps, kernels):
            setattr(mod, name, kernel)
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


def train_run(dev, label, model_name, batch, expected, flops_per_sample, plain_kind):
    """TRAIN_STEPS steps of the port's trainer at cfgs/egom2p/main_mod4.yaml's
    settings, checked; then a profiled step and the one-batch step check.
    Returns (launch totals, median step ms)."""
    from egom2p_torch.cli import run_training
    from egom2p_torch.data.loader import batch_to_device
    from egom2p_torch.models.egom2p import create_model

    with tempfile.TemporaryDirectory() as out_dir:
        args = run_training.get_args([
            "--synthetic_data", "--model", model_name,
            "--num_input_tokens", "2048", "--num_target_tokens", "2048", "--loss_type", "mod",
            "--batch_size", str(batch), "--accum_steps", "1", "--blr", "1e-4", "--min_blr", "0",
            "--opt_betas", "0.9", "0.95", "--weight_decay", "0.05", "--clip_grad", "1.0",
            "--lr_schedule", "constant", "--epochs", "1",
            "--epoch_size", str(batch * TRAIN_STEPS),
            "--seed", "0", "--output_dir", out_dir, "--print_freq", "1"])
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
                              mmap=True, weights_only=False)["step"] == TRAIN_STEPS)
    if not ckpt_ok or len(per_step) != TRAIN_STEPS:
        raise AssertionError(f"{label}: {len(per_step)} steps ran, checkpoint ok: {ckpt_ok}")
    for step, (launches, metrics, _) in enumerate(per_step):
        if launches != expected:
            raise AssertionError(f"{label} step {step} launched {launches}, expected {expected}")
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{label} step {step}: non-finite metrics {metrics}")
    # a modality's loss is exactly 0 in a batch that holds none of its
    # targets (the Dirichlet budgets often give cam and gaze none): check
    # each at the first step that has its targets
    for mod, vocab in (("tok_rgb", 64000), ("tok_depth", 64000), ("tok_cam", 256),
                       ("tok_gaze", 256)):
        losses = [m[f"loss_{mod}"] for _, m, _ in per_step if m[f"loss_{mod}"] != 0.0]
        if not losses or abs(losses[0] - math.log(vocab)) > 0.5:
            raise AssertionError(f"{label} {mod}: first losses {losses[:1]}, ln {vocab} = "
                                 f"{math.log(vocab):.3f}")
    model = out["model"]
    init = create_model(args.model, run_training.MODS4, run_training.MODS4, device=dev)
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
    return totals, step_ms



def train_slice_phase(dev):
    return train_run(dev, "EgoM2P-base", BASE_MODEL, B, DEFAULT_STEP,
                     train_flops_per_sample(), "default")


def fused_train_phase(dev, default_ms):
    """The base training run with both fused backward kernels switched on
    for this phase only."""
    with _env(EGOM2P_F64T_FUSED_BWD="1", EGOM2P_CE_PALLAS_BWD="1"):
        totals, step_ms = train_run(dev, "EgoM2P-base, fused backwards", BASE_MODEL, B,
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
                     "large")


# instances of the attention kernels: at head_dim 64 the SAFEMAX/SEG/L2
# combinations of the forward, CLAMP x SEG of dq, CLAMP x SEG x FUSED of dk/dv;
# at head_dim 80 (the stock route) the safemax L2 forward and the safemax
# fused backward, each with and without segments
WGMMA64_INSTANCES = {"flash64_fwd_kernel": 6 + 2, "flash64_dq_kernel": 4,
                     "flash64_dkv_kernel": 8 + 2, "flash_ce_fwd_kernel": 1}


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
    launches, safemax_launches, _ = phase(slice_phase, dev)
    train_rows = phase(train_kernel_phase, dev)
    ce_rows = phase(ce_phase, dev)
    train_launches, default_ms = phase(train_slice_phase, dev)
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
        exp2_bound_ms=serve_exp2)
    add("flash64_fwd_safemax", "flash64_fwd.cu", "flash64.py:119", safemax_launches, max_err,
        rows[1]["ms"], rows[1]["plain_ms"], serve_bound, rows[1]["library_ms"],
        exp2_bound_ms=serve_exp2)
    # the library's backward computes dq, dk and dv in one call: the split
    # kernels' rows both carry it
    step_lib = step_case["library_ms"]
    for name, src, line, part, keys, products, tensors, lib, more in (
            ("flash64_train_fwd", "flash64_fwd.cu", 69, "fwd", ("o",), 2, (2, 2), step_lib["fwd"],
             {"exp2_bound_ms": exp2_bound_ms(B, HEADS, 2048, 2048, SM_CLOCK_MHZ)}),
            ("flash64_train_dq", "flash64_train.cu", 172, "dq", ("dq",), 3, (3, 2),
             step_lib["bwd"], {"library_computes": "dq, dk and dv"}),
            ("flash64_train_dkv", "flash64_train.cu", 232, "dkv", ("dk", "dv"), 4, (2, 4),
             step_lib["bwd"], {"library_computes": "dq, dk and dv"})):
        add(name, src, f"flash64_train.py:{line}", train_launches[part], errs(*keys),
            step_case["ms"][part], step_case["plain_ms"][part],
            attention_bound_ms(products, B, HEADS, 2048, 2048, 64, *tensors), lib, **more)
    add("flash64_train_dqkv", "flash64_train.cu", "flash64_train.py:296",
        fused_launches["dqkv"], max(r["err"] for r in fused_rows),
        fused_rows[0]["ms"], fused_rows[0]["plain_ms"],
        attention_bound_ms(5, B, HEADS, 2048, 2048, 64, 4, 4), step_lib["bwd"])
    # ce_rows[0]: R = 16384, D = 768, every row live; no single PyTorch call
    # computes logsumexp and gold without the logits: matmul_ms is cuBLAS's
    # y @ W^T alone, which writes them
    add("flash_ce_fwd", "flash_ce_fwd.cu", "flash_ce.py:76", train_launches["ce_fwd"],
        max(r["err"] for r in ce_rows), ce_rows[0]["ms"], ce_rows[0]["plain_ms"],
        ce_fwd_bound_ms(ce_rows[0]["R"], 768, ce_rows[0]["V"]), None,
        matmul_ms=ce_rows[0]["matmul_ms"])
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
        library_math_ms=lib["math_fwd"], instance="head_dim 80")
    add("stock_flash_bwd", "flash64_train.cu", "flash_attention.py:93",
        large_launches["stock_bwd"], stock_errs("dq", "dk", "dv"), stock_rows[0]["ms"]["bwd"],
        stock_rows[0]["plain_ms"]["bwd"],
        attention_bound_ms(5, B, LARGE_HEADS, 2048, 2048, LARGE_HD, 4, 4), lib["bwd"],
        library_math_ms=lib["math_bwd"], instance="head_dim 80")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
