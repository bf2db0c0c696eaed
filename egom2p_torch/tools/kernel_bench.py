#!/usr/bin/env python3
"""Time the forward attention kernel, the attention backward kernels, the
stock route's kernels at EgoM2P-large's heads, the CE kernels (the forward
also at small R and with half the rows live) and the serving
slice of one checkout of the port at the main paths' shapes, each kernel
checked against its plain version first.

    python3 egom2p_torch/tools/kernel_bench.py [--root DIR] [--only fwd,bwd,stock,ce,serve] [--reps N]

`--root` names the checkout whose `egom2p_torch` is imported (default: the
one this file lies in), so two commits can be compared inside one process
sequence on one card: unpack the other commit somewhere and run this file
once per root, in turns.  Needs a CUDA device; prints one JSON object per
measurement, then the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

B, HEADS = 8, 12


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused_views(rng, n_q, n_kv, dev):
    C = HEADS * 64
    qkv = torch.from_numpy(rng.standard_normal((B, n_q, 3 * C), np.float32)).to(dev, torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal((B, n_kv, 2 * C), np.float32)).to(dev, torch.bfloat16)
    return qkv[..., :C], kv[..., :C], kv[..., C:]


def bench_fwd(dev, reps):
    from egom2p_torch.ops import flash64 as f64
    from egom2p_torch.ops import flash64_train as ft

    rng = np.random.default_rng(0)
    for name, n_q, n_kv, live in (("8704^2 key padding", 8704, 8704, 8534),
                                  ("1707x3584 key padding", 1707, 3584, 3414),
                                  ("1707^2 no mask", 1707, 1707, None)):
        q, k, v = fused_views(rng, n_q, n_kv, dev)
        blocked = None
        if live is not None:
            blocked = (torch.arange(n_kv, device=dev) >= live)[None].expand(B, -1).contiguous()
        for safemax in (False, True):
            out = f64.flash64_attention(q, k, v, blocked, safemax=safemax)
            torch.cuda.synchronize()
            ref = f64.flash64_attention_reference(q, k, v, blocked, safemax=safemax)
            err = (out.float() - ref.float()).abs().max().item()
            ms = cuda_ms(lambda: f64.flash64_attention(q, k, v, blocked, safemax=safemax), reps)
            yield {"kernel": "flash64_fwd", "case": name, "safemax": safemax, "ms": ms,
                   "tflops": 4.0 * B * HEADS * n_q * n_kv * 64 / ms / 1e9, "max_abs_err": err}
        del q, k, v
    # the training forward: self-attention views of one qkv projection
    n, C = 2048, HEADS * 64
    qkv = torch.from_numpy(rng.standard_normal((B, n, 3 * C), np.float32)).to(dev, torch.bfloat16)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    live = torch.from_numpy(rng.integers(n // 2, n, B)).to(dev)
    kvb = torch.arange(n, device=dev)[None] >= live[:, None]
    ids = torch.tensor([31433, 17061, 7210, 25377, -1], device=dev, dtype=torch.int32)
    seg = ids[torch.from_numpy(np.sort(rng.integers(0, 5, (B, n)), axis=1)).to(dev)]
    for name, mk, sg in (("2048^2 key padding", kvb, None), ("2048^2 segments", None, seg)):
        for safemax in (False, True):
            o, l2 = ft.flash64_train_fwd(q, k, v, mk, sg, safemax)
            torch.cuda.synchronize()
            ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, mk, sg, safemax)
            err = max((o.float() - ro.float()).abs().max().item(), (l2 - rl2).abs().max().item())
            ms = cuda_ms(lambda: ft.flash64_train_fwd(q, k, v, mk, sg, safemax), reps)
            yield {"kernel": "flash64_train_fwd", "case": name, "safemax": safemax, "ms": ms,
                   "tflops": 4.0 * B * HEADS * n * n * 64 / ms / 1e9, "max_abs_err": err}


def _rel_err(got, ref):
    """max |got - ref| over max |ref| (0 where both are all zeros)."""
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    return err / scale if scale > 0 else err


def bench_bwd(dev, reps):
    """The head_dim-64 attention backward (dq, dk/dv and the fused dq/dk/dv
    kernel) at the training step's 2048^2 with key padding and with segments,
    both softmax forms.  Errors are relative to each gradient's max."""
    from egom2p_torch.ops import flash64_train as ft

    rng = np.random.default_rng(1)
    n, C = 2048, HEADS * 64
    qkv = torch.from_numpy(rng.standard_normal((B, n, 3 * C), np.float32)).to(dev, torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((B, n, C), np.float32)).to(dev, torch.bfloat16)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    live = torch.from_numpy(rng.integers(n // 2, n, B)).to(dev)
    live[0] = n
    kvb = torch.arange(n, device=dev)[None] >= live[:, None]
    ids = torch.tensor([31433, 17061, 7210, 25377, -1], device=dev, dtype=torch.int32)
    seg = ids[torch.from_numpy(np.sort(rng.integers(0, 5, (B, n)), axis=1)).to(dev)]
    for name, mk, sg in (("2048^2 key padding", kvb, None), ("2048^2 segments", None, seg)):
        for safemax in (False, True):
            ro, rl2 = ft.flash64_train_reference_fwd(q, k, v, mk, sg, safemax)
            args = (q, k, v, do, rl2, ft.row_dot(do, ro), mk, sg, safemax)
            rdq, rdk, rdv = ft.flash64_train_reference_dqkv(*args)
            dq = ft.flash64_train_dq(*args)
            dk, dv = ft.flash64_train_dkv(*args)
            fq, fk, fv = ft.flash64_train_dqkv(*args)
            torch.cuda.synchronize()
            case = {"case": name, "safemax": safemax}
            yield {"kernel": "flash64_train_dq", **case,
                   "ms": cuda_ms(lambda: ft.flash64_train_dq(*args), reps),
                   "max_rel_err": _rel_err(dq, rdq)}
            yield {"kernel": "flash64_train_dkv", **case,
                   "ms": cuda_ms(lambda: ft.flash64_train_dkv(*args), reps),
                   "max_rel_err": max(_rel_err(dk, rdk), _rel_err(dv, rdv))}
            yield {"kernel": "flash64_train_dqkv", **case,
                   "ms": cuda_ms(lambda: ft.flash64_train_dqkv(*args), reps),
                   "max_rel_err": max(_rel_err(fq, rdq), _rel_err(fk, rdk), _rel_err(fv, rdv))}
            del ro, rl2, args, rdq, rdk, rdv, dq, dk, dv, fq, fk, fv


def bench_stock(dev, reps):
    """The stock route's forward and fused backward kernels at EgoM2P-large's
    heads: B = 8, 15 heads of 68 packed to head_dim 80, 2048^2, with key
    padding and with segments.  Errors are relative to each output's max;
    dk and dv are deterministic, so equal sums mean equal results."""
    from egom2p_torch.ops import flash64_train as ft
    from egom2p_torch.ops import flash_attention as fa

    rng = np.random.default_rng(6)
    n, heads, hd = 2048, 15, 68
    hdk, C = fa.kernel_head_dim(hd), heads * hd
    split = lambda t: t.unflatten(-1, (heads, hd)).transpose(1, 2)  # noqa: E731
    qkv = torch.from_numpy(rng.standard_normal((B, n, 3 * C), np.float32)).to(dev, torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((B, heads, n, hd), np.float32)).to(dev, torch.bfloat16)
    qp, kp, vp, dop = (fa._pack(t, hdk) for t in (split(qkv[..., :C]), split(qkv[..., C:2 * C]),
                                                  split(qkv[..., 2 * C:]), do))
    live = torch.from_numpy(rng.integers(n // 2, n, B)).to(dev)
    live[-1] = 0  # a fully blocked batch row
    kvb = torch.arange(n, device=dev)[None] >= live[:, None]
    ids = torch.tensor([31433, 17061, 7210, 25377, -1], device=dev, dtype=torch.int32)
    seg = ids[torch.from_numpy(np.sort(rng.integers(0, 5, (B, n)), axis=1)).to(dev)]
    kw = dict(hd=hdk, sm_scale=hd ** -0.5)
    for name, mk, sg in (("key padding", kvb, None), ("segments", None, seg)):
        case = f"15 heads of 68 (kernel {hdk}), 2048^2, {name}"
        o, l2 = fa.flash_attention_fwd(qp, kp, vp, mk, sg, **kw)
        torch.cuda.synchronize()
        ro, rl2 = ft.flash64_train_reference_fwd(qp, kp, vp, mk, sg, True, **kw)
        yield {"kernel": "stock_flash_fwd", "case": case,
               "ms": cuda_ms(lambda: fa.flash_attention_fwd(qp, kp, vp, mk, sg, **kw), reps),
               "max_rel_err": max(_rel_err(o, ro), (l2 - rl2).abs().max().item())}
        bargs = (qp, kp, vp, dop, rl2, ft.row_dot(dop, ro, hdk), mk, sg)
        got = fa.flash_attention_bwd(*bargs, **kw)
        torch.cuda.synchronize()
        ref = ft.flash64_train_reference_dqkv(*bargs, True, **kw)
        yield {"kernel": "stock_flash_bwd", "case": case,
               "ms": cuda_ms(lambda: fa.flash_attention_bwd(*bargs, **kw), reps),
               "max_rel_err": max(_rel_err(g, r) for g, r in zip(got, ref)),
               "dk_sum": got[1].double().sum().item(),
               "dv_abs_sum": got[2].double().abs().sum().item()}
        del o, l2, ro, rl2, bargs, got, ref


def _step_live_rows(R, dev, gen):
    """One 64k head's rows in a training step: a run of 1024 live rows at a
    random start in each 2048-row sample (about half the rows)."""
    start = torch.randint(0, 1024, (R // 2048 + 1,), device=dev, generator=gen)
    pos = torch.arange(R, device=dev)
    return ((pos % 2048) >= start[pos // 2048]) & ((pos % 2048) < start[pos // 2048] + 1024)


# CE forward cases (R, V, D, rows): chip_smoke.py's; "step" rows have half
# the rows live, which a checkout whose row_stats takes `live` skips
CE_FWD_CASES = ((16384, 64000, 768, "all"), (16384, 64000, 1024, "all"),
                (16384, 64000, 2048, "all"), (16384, 64000, 768, "step"),
                (1000, 64007, 768, "all"), (2048, 64000, 768, "all"),
                (512, 64000, 1024, "all"))


def bench_ce(dev, reps):
    """The CE forward kernel at CE_FWD_CASES (errors over the live rows), and
    the CE backward kernel at the training step's R = 16384, V = 64000, D =
    768 and 512."""
    import inspect

    from egom2p_torch.ops.flash_ce import (_bwd_chunked, ce_bwd, row_stats,
                                           row_stats_reference)

    takes_live = "live" in inspect.signature(row_stats).parameters
    for R, V, D, rows in CE_FWD_CASES:
        gen = torch.Generator(device=dev).manual_seed(R + D)
        y = torch.randn((R, D), device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn((V, D), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        t = torch.randint(0, V, (R,), device=dev, generator=gen, dtype=torch.int32)
        live = _step_live_rows(R, dev, gen) if rows == "step" else None
        kw = {"live": live} if takes_live and live is not None else {}
        klz, kgold = row_stats(y, w, t, **kw)
        torch.cuda.synchronize()
        logz, gold = row_stats_reference(y, w, t)
        on = torch.ones(R, dtype=torch.bool, device=dev) if live is None else live
        yield {"kernel": "flash_ce_fwd", "case": f"R {R} D {D} V {V}, {int(on.sum())} rows live",
               "dead_rows_skipped": bool(kw),
               "ms": cuda_ms(lambda: row_stats(y, w, t, **kw), reps, 1),
               "max_abs_err": max((klz[on] - logz[on]).abs().max().item(),
                                  (kgold[on] - gold[on]).abs().max().item())}
        del y, w
    R, V = 16384, 64000
    for D in (768, 512):
        gen = torch.Generator(device=dev).manual_seed(R + 1)
        y = torch.randn((R, D), device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn((V, D), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        t = torch.randint(0, V, (R,), device=dev, generator=gen, dtype=torch.int32)
        live = _step_live_rows(R, dev, gen)
        logz, _ = row_stats_reference(y, w, t)
        for name, wc in (("half the rows live", live.float() / live.sum()),
                         ("all rows live", torch.full((R,), 1.0 / R, device=dev))):
            dy, dw = ce_bwd(y, w, t, wc, logz)
            torch.cuda.synchronize()
            rdy, rdw = _bwd_chunked(y, w, t, wc, logz, 2048, dy_f32=True)
            err = max(((dy - rdy).abs().max() / rdy.abs().max()).item(),
                      ((dw - rdw).abs().max() / rdw.abs().max()).item())
            ms = cuda_ms(lambda: ce_bwd(y, w, t, wc, logz), reps, 1)
            chunked_ms = cuda_ms(lambda: _bwd_chunked(y, w, t, wc, logz, 2048), 3, 1)
            yield {"kernel": "flash_ce_bwd", "case": f"R {R} D {D} V {V}, {name}", "ms": ms,
                   "chunked_ms": chunked_ms, "max_rel_err": err}
            del dy, dw, rdy, rdw
        del y, w


def bench_serve(dev, reps):
    """The serving slice of chip_smoke.py (tokenize + 3-step rgb2depth, B = 8,
    median of 3 runs) on the package of `--root`."""
    sys.path.append(str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    launches, _, clips_per_s = chip_smoke.slice_phase(dev)
    yield {"kernel": "serving slice", "clips_per_s": clips_per_s, "flash64_launches": launches}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--only", help="comma-separated phases of fwd, bwd, stock, ce, serve "
                                   "(default: all)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from egom2p_torch.ops import _build

    dev = torch.device("cuda", 0)
    _build.load()
    print(f"root {args.root}: kernel build {_build.build_seconds():.1f} s")
    entry = ""
    for line in _build.ptxas_log().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif any(word in line for word in ("registers", "spill", "wgmma", "warning", "setmaxnreg")):
            print(f"  ptxas [{entry}]: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    table = {"fwd": bench_fwd, "bwd": bench_bwd, "stock": bench_stock, "ce": bench_ce,
             "serve": bench_serve}
    picked = args.only.split(",") if args.only else list(table)
    if not set(picked) <= set(table):
        ap.error(f"--only takes phases of {', '.join(table)}, got {args.only}")
    phases = [table[name] for name in picked]
    for phase in phases:
        for row in phase(dev, args.reps):
            print(json.dumps({"root": args.root, **row}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
