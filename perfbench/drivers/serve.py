"""Serving driver: a closed loop of one batch in flight through the
inference user's whole path.  Each batch of uint8 clips, drawn in turn from
a seeded pool in pinned host memory, is copied to the card, tokenized and
generated by `eval_common.run_clip` (Cosmos encode, ROAR with guidance),
and decoded to uint8 video on the host by `decode_video_tokens`.

Set-up builds the model and the tokenizer with seeded weights made on the
card, makes the pool, and runs one batch (every shape the window uses:
ROAR's encoder buckets are the same for every batch).  The window then
runs batches until the first that ends `seconds` after it opened.  After
it: the peak memory, the program freed, and the reference check of one
batch drawn from the seed among those the window finished.

The traffic's `cfg_scale` and `top_p` are the program's own (the ROAR
schedule's guidance, the top-p that `run_clip` hands the sampler): the
driver reads them from the program and refuses a traffic that asks for
others.  With `"decode": false` a batch ends at its tokens: no Cosmos
decode, no video compared.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import core, weights
from perfbench.work import WorkCounter

# the traffic keys this driver reads; run.py refuses a traffic file with others
TRAFFIC_KEYS = ("batch", "clip", "pool", "cond", "target", "decoding_steps", "cfg_scale",
                "temperature", "top_p", "decode")


def cosmos_flops(tok_cfg, clip, batch):
    """(encode, decode) FLOPs of one batch from the networks' shapes:
    FlopCounterMode over the reference tokenizer on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.reference import cosmos
    cfg = cosmos.config_of(tok_cfg)
    with torch.device("meta"):
        net = cosmos.DiscreteVideoTokenizer(cfg)
    x = torch.empty((batch, *clip), dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as enc:
        idx = net.tokenize(x)
    with FlopCounterMode(display=False) as dec:
        net.decode(idx, clip[0], True)
    return float(enc.get_total_flops()), float(dec.get_total_flops())


def _check_widths(model, cfg) -> None:
    m, c = model.config, cfg["model"]
    got = (m.dim, m.encoder_depth, m.decoder_depth, m.num_heads)
    want = (c["dim"], c["encoder_depth"], c["decoder_depth"], c["num_heads"])
    if got != want:
        raise ValueError(f"the program's {c['registry_name']} is {got}, the configuration {want}")


def _check_tokenizer(program_cfg, tok_cfg) -> None:
    from perfbench.reference import cosmos
    want = cosmos.config_of(tok_cfg)
    for f in ("channels", "channels_mult", "num_res_blocks", "z_channels", "patch_size",
              "spatial_compression", "temporal_compression", "levels"):
        if tuple(np.atleast_1d(getattr(program_cfg, f))) != tuple(np.atleast_1d(getattr(want, f))):
            raise ValueError(f"the program's video tokenizer has another {f} "
                             "than the configuration")


def _recorded(fn, calls):
    """`fn`, each call's arguments appended to `calls`."""
    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)
    return recorded


def run(ctx) -> core.RunResult:
    from egom2p_torch.cli import eval_common
    from egom2p_torch.generate.decode import decode_video_tokens
    from egom2p_torch.generate.sampler import GenerationSampler
    from egom2p_torch.models.egom2p import create_model
    from egom2p_torch.tokenizers.cosmos.network import CausalDiscreteVideoTokenizer
    from egom2p_torch.tokenizers.cosmos.video_api import CausalVideoTokenizer

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    B, clip = tr["batch"], tuple(tr["clip"])
    mods = sorted(cfg["modalities"])
    grid = tuple(cfg["modalities"][tr["target"]]["grid"])
    model_seed, tok_seed = weights.sub_seed(seed, 1), weights.sub_seed(seed, 2)

    model = create_model(cfg["model"]["registry_name"], in_domains=mods, out_domains=mods,
                         device=dev)
    _check_widths(model, cfg)
    weights.fill_module_(model.named_parameters(), model_seed, "egom2p")
    model.eval()
    _check_tokenizer(eval_common.COSMOS_CONFIG, cfg["tokenizer"])
    net = CausalDiscreteVideoTokenizer(eval_common.COSMOS_CONFIG).to(dev)
    weights.fill_module_(net.named_parameters(), tok_seed, "cosmos")
    tokenizer = CausalVideoTokenizer(net)
    sampler = GenerationSampler(model)
    schedule = eval_common.roar_schedule(tr["cond"], tr["target"], tr["decoding_steps"],
                                         tr["temperature"])
    if any(s["cfg_scale"] != tr["cfg_scale"] for s in schedule):
        raise ValueError("the program's ROAR schedule guides at another scale than the traffic's")
    pool = weights.clip_pool(weights.sub_seed(seed, 3), tr["pool"], clip, dev)
    counter = WorkCounter(model, ctx.peaks)
    enc_fl, dec_fl = cosmos_flops(cfg["tokenizer"], clip, B)
    if not tr["decode"]:
        dec_fl = 0.0
    head_fl = sum(2.0 * B * s["num_tokens"] * cfg["model"]["dim"]
                  * cfg["modalities"][tr["target"]]["vocab_size"] for s in schedule)
    n_batches_pool = tr["pool"] // B

    def one_batch(i: int, tag):
        host = pool[(i % n_batches_pool) * B:(i % n_batches_pool + 1) * B]
        counter.tag = tag
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench:copy"):
            video = host.to(dev, non_blocking=True)
        with torch.profiler.record_function("perfbench:run_clip"):
            out, secs = eval_common.run_clip(video, sampler, tokenizer, schedule, tr["cond"],
                                             tr["target"], seed=weights.sub_seed(seed, 100 + i))
        t1 = time.perf_counter()
        done = {}
        if tr["decode"]:
            with torch.profiler.record_function("perfbench:decode"):
                done["video"] = decode_video_tokens(out[tr["target"]]["tensor"], tokenizer,
                                                    key=tr["target"], grid=grid)
        t2 = time.perf_counter()
        if tr["decode"]:
            done["decode_s"] = t2 - t1
        cond = out[tr["cond"]]["tensor"]
        return {"i": i, "tokenize_s": secs["tokenize_s"], "generate_s": secs["generate_s"],
                "total_s": t2 - t0,
                "cond": cond.cpu().numpy() if isinstance(cond, torch.Tensor) else cond,
                "served": np.asarray(out[tr["target"]]["tensor"]), **done}

    counter.active = True
    sampler_calls = []
    sampler.generate = _recorded(sampler.generate, sampler_calls)
    one_batch(-1, "warmup")
    del sampler.generate
    top_p = [k.get("top_p") for _, k in sampler_calls]
    if top_p != [tr["top_p"]]:
        raise ValueError(f"the program's sampler took top_p {top_p}; the traffic's is "
                         f"{tr['top_p']}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    window = core.Window(ctx.seconds)
    opened_wall = time.time()
    window.open()
    batches, prof, stopped, traced = [], None, None, set()
    t_prof = 0.0
    while True:
        i = len(batches)
        if ctx.trace and i == 1:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.start()
            t_prof = time.perf_counter()
        tag = ("traced", i) if prof is not None else i
        batches.append(one_batch(i, tag))
        if prof is not None:
            traced.add(tag)
        if prof is not None and i == 2:
            stretch_s = time.perf_counter() - t_prof
            prof.stop()
            stopped, prof = prof, None
        if window.mark() and (not ctx.trace or stopped is not None):
            break
    counter.active = False
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = core.Trace.from_profile(stopped, stretch_s) if stopped is not None else None

    untraced = [b for b in batches if ("traced", b["i"]) not in traced]
    work_all = counter.reduce({b["i"] for b in untraced})
    work_traced = counter.reduce(traced) if traced else {}
    flops = work_all["model_flops"] + len(untraced) * (enc_fl + dec_fl + head_fl)
    layer = {"batches": batches, "trace": trace, "work": work_traced,
             "untraced_s": sum(b["total_s"] for b in untraced), "untraced_flops": flops,
             "traced_units": len(traced),
             "untraced_unit_s": sum(b["total_s"] for b in untraced) / max(len(untraced), 1),
             "peak_flops": ctx.peaks["bf16_flops_per_s"]}
    clips = B * len(batches)
    e2e = {"clips_per_s": clips / window.length, "peak_mem_gib": peak / 2 ** 30,
           "setup_s": opened_wall - ctx.started}

    # ------------------------------------------------ the program is freed
    chosen = batches[int(np.random.default_rng(weights.sub_seed(seed, 4)).integers(len(batches)))]
    counter.close()
    del model, sampler, tokenizer, net, counter
    for b in batches:
        if b is not chosen:
            b.pop("video", None)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(ctx, chosen, pool, model_seed, tok_seed, grid)
    ctx.readings["check_s"] = time.perf_counter() - t_check
    busy = trace.busy_us() / 1e6 if trace is not None else None
    breakdown = ({"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
                 if trace is not None else None)
    return core.RunResult(e2e=e2e, layer=layer, checks=checks, attempted=clips, failed=0,
                          memory_peak_bytes=peak, count=1, busy_s=busy,
                          window_s=trace.wall_s if trace is not None else None,
                          breakdown=breakdown)


def check(ctx, chosen, pool, model_seed, tok_seed, grid):
    """The three stages of reference/serve_check.py on the chosen batch."""
    from perfbench.reference import serve_check
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    lim = ctx.limits
    B = tr["batch"]
    i = chosen["i"] % (tr["pool"] // B)
    clips = pool[i * B:(i + 1) * B]
    out = {}
    with torch.no_grad():
        out.update(serve_check.check_tokens(clips, chosen["cond"], cfg["tokenizer"], tok_seed,
                                            dev))
        if tr["decode"]:
            out.update(serve_check.check_decode(chosen["served"], chosen["video"],
                                                cfg["tokenizer"], grid, tok_seed, dev,
                                                gray=tr["target"] == "tok_depth"))
        ref = serve_check.model_reference(cfg, model_seed, dev)
        out.update(serve_check.check_generation(
            ref, chosen["cond"], chosen["served"], tr["cond"], tr["target"],
            weights.sub_seed(ctx.seed, 100 + chosen["i"]), tr["decoding_steps"],
            tr["cfg_scale"]))
    ctx.readings = out
    names = ("tokens_differ", "gap_max", "gap_p99") + (("video_off",) if tr["decode"] else ())
    return [core.Check(name, out[name], lim[name]) for name in names]
