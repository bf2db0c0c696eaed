"""One rank of the port's data-parallel and FSDP checks, run as its own
process.

    python tests/torch_dist_ranks.py JOB_DIR RANK WORLD

Reads JOB_DIR/job.pt (the model's weights and the global batches, written
by tests/test_torch_distributed.py, test_torch_fsdp.py or
test_torch_vqvae_dist.py), joins the gloo group through a file under
JOB_DIR, runs the job's cases in order on its rows of each global batch
and writes what it computed to JOB_DIR/rank{RANK}.pt.  A case may keep its
parameters after its steps (`keep`) for a later case of the same process
to compare bitwise (`same_as`).  Imports the port only, never JAX, so that
a rank starts in a few seconds.
"""
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

NAME = "egom2p_tiny_6e_6d_swiglu_nobias"
MODS4 = ("tok_cam", "tok_depth", "tok_gaze", "tok_rgb")
TOKENS = 32


KEPT = {}  # case name -> full parameters after its steps (`keep`)


def build_model(state, remat=False):
    from egom2p_torch.data.modality_info import make_scaled_modality_info
    from egom2p_torch.models.egom2p import create_model

    model = create_model(NAME, MODS4, MODS4, modality_info=make_scaled_modality_info(),
                         compute_dtype="float32", use_act_checkpoint=remat)
    model.load_state_dict(state)
    return model


def rows_of(batch, lo, hi):
    return {m: {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi])) for k, v in d.items()}
            for m, d in batch.items()}


def step_case(state, batch, accum, rank, world, loss_type="mod"):
    """One train step on this rank's rows of `batch`: the metrics, whether
    the parameters after it equal rank 0's bitwise and, on rank 0, the
    summed gradients the optimizer saw."""
    from egom2p_torch.core.optim import Optimizer
    from egom2p_torch.train.egom2p_train import make_train_step

    model = build_model(state)
    opt = Optimizer(model, [1e-3], clip_grad=None)
    names = {id(p): n for n, p in model.named_parameters()}
    seen = {}
    real_step = opt.step

    def step():
        seen.update({names[id(p)]: p.grad.clone() for p in opt.params})
        return real_step()

    opt.step = step
    rows = len(next(iter(batch.values()))["tensor"]) // world
    metrics = make_train_step(model, opt, TOKENS, TOKENS, loss_type, accum)(
        rows_of(batch, rank * rows, (rank + 1) * rows), torch.Generator().manual_seed(5))
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    out = {"metrics": {k: v.item() for k, v in metrics.items()},
           "synced": bool(torch.equal(ref, flat))}
    if rank == 0:
        out["grads"] = seen
    return out


def fsdp_case(name, state, case, rank, world):
    """Train steps of the port's step on this rank's rows, the model
    sharded (core/fsdp.py) or data-parallel: `batches` one global batch a
    step, with `accum`, `clip`, `remat` and `frozen` (freeze_until's
    steps; `none_grad` a parameter whose gradient rank 1 drops before the
    reduction), after resuming from the
    checkpoint directory `load`, saving to
    `save` (rank 0 writes) after the first step.  Returns every step's
    metrics; between the steps whether the rank held only its pieces (the
    parameters' element count, every full parameter's storage freed); the
    full parameters after the last step against the other ranks'
    (bitwise), against `same_as`'s (bitwise) and against `ref` (the
    largest difference of each tensor)."""
    from egom2p_torch.core import fsdp
    from egom2p_torch.core.checkpoint import auto_load_model, save_checkpoint
    from egom2p_torch.core.optim import Optimizer, freeze_until, shared_params_mask
    from egom2p_torch.train.egom2p_train import make_train_step

    model = build_model(state, case.get("remat", False))
    sharded = fsdp.shard_model(model) if case.get("fsdp") else None
    opt = Optimizer(model, [case.get("lr", 1e-3)], clip_grad=case.get("clip"))
    if case.get("frozen"):
        freeze_until(case["frozen"], shared_params_mask(model), opt, model)
    if case.get("load"):
        auto_load_model(case["load"], model, opt)
    restore = _drop_grad(model, sharded, case["none_grad"]) \
        if case.get("none_grad") and rank == 1 else None
    step = make_train_step(model, opt, TOKENS, TOKENS, "mod", case.get("accum", 1))
    out = {"metrics": [], "pieces_only": []}
    for i, batch in enumerate(case["batches"]):
        rows = len(next(iter(batch.values()))["tensor"]) // world
        m = step(rows_of(batch, rank * rows, (rank + 1) * rows), torch.Generator().manual_seed(5))
        out["metrics"].append({k: v.item() for k, v in m.items()})
        out["numel"] = sum(p.numel() for p in model.parameters())
        if sharded is not None:
            out["pieces_only"].append(all(s.full.untyped_storage().nbytes() == 0
                                          for s in sharded.params))
        if i == 0 and case.get("save"):
            save_checkpoint(case["save"], "0", model, opt, step=1, write=rank == 0)
            dist.barrier()
    if restore is not None:
        restore()
    full = fsdp.full_state_dict(model)
    flat = torch.cat([t.reshape(-1) for t in full.values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    out["synced"] = bool(torch.equal(ref, flat))
    if case.get("keep"):
        KEPT[name] = full
    if case.get("same_as"):
        other = KEPT[case["same_as"]]
        out["same"] = all(torch.equal(full[k], other[k]) for k in full)
    if case.get("ref") is not None:
        out["ref_err"] = {k: (full[k] - v).abs().max().item() for k, v in case["ref"].items()}
    return out


def _drop_grad(model, sharded, keys):
    """Drop the gradients of the parameters `keys` just before the step's
    reduction, as when no row of this rank reaches a head; returns the
    undo.  Under FSDP a sharded parameter's full gradient is dropped."""
    from egom2p_torch.core import distributed

    params = dict(model.named_parameters())
    reduce_dp = distributed.all_reduce_grads_

    def drop():
        for key in keys:
            s = sharded.by_key.get(key) if sharded is not None else None
            if s is not None:
                s.full.grad = None
            else:
                params[key].grad = None

    def dropped_dp(ps):
        drop()
        return reduce_dp(ps)

    distributed.all_reduce_grads_ = dropped_dp  # the replicated ones, under FSDP too
    if sharded is None:
        return lambda: setattr(distributed, "all_reduce_grads_", reduce_dp)
    reduce_fsdp = sharded.reduce_grads_

    def dropped_fsdp(replicated):
        drop()
        return reduce_fsdp(replicated)

    sharded.reduce_grads_ = dropped_fsdp

    def undo():
        distributed.all_reduce_grads_ = reduce_dp
        sharded.reduce_grads_ = reduce_fsdp

    return undo


def vq_case(case, rank, world):
    """ops/vq.py:vq_forward on this rank's rows of a global latent batch,
    its statistics summed and its pool gathered over the ranks: the new
    codebook state, this rank's commitment share and its indices."""
    from egom2p_torch.core import distributed
    from egom2p_torch.ops import vq

    x = case["x"]
    rows = len(x) // world
    state = vq.VQState(**{k: torch.from_numpy(v) if v is not None else None
                          for k, v in case["state"].items()})
    _, commit, ind, new = vq.vq_forward(
        vq.VQConfig(**case["cfg"]), state, torch.from_numpy(x[rank * rows:(rank + 1) * rows]),
        stats_reduce=distributed.all_reduce_sum_, pool_gather=distributed.all_gather_rows,
        world=world, **case["draws"])
    return {"commit": commit.item(), "ind": ind.numpy(),
            "state": {k: None if v is None else v.numpy() for k, v in vars(new).items()}}


def vqvae_case(case, rank, world):
    """Steps of the VQ-VAE trainer's step (train/vqvae_train.py) on this
    rank's rows of each global batch, the expiry draws given: the metrics,
    whether the weights and codebook after the last step equal rank 0's
    bitwise and, on rank 0, them and Adam's second moments."""
    from egom2p_torch.core.optim import Optimizer
    from egom2p_torch.tokenizers import seq_vqvae as tseq
    from egom2p_torch.train.vqvae_train import make_vqvae_train_step

    tok = tseq.seq_vqvae_from_config(case["domain"], **case["config"])
    tok.net.load_state_dict(case["state"])
    opt = Optimizer(tok.net, case["sched"], weight_decay=case["wd"], betas=case["betas"],
                    clip_grad=1.0, decay_all=True)
    step = make_vqvae_train_step(tok.net, opt, case["loss_fn"])
    out = {"metrics": []}
    for batch, draws in zip(case["batches"], case["draws"]):
        rows = len(batch) // world
        m = step(torch.from_numpy(batch[rank * rows:(rank + 1) * rows]), **draws)
        out["metrics"].append({k: v.item() for k, v in m.items()})
    sd = tok.net.state_dict()
    flat = torch.cat([t.float().reshape(-1) for t in sd.values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    out["synced"] = bool(torch.equal(ref, flat))
    out["state"] = {k: v.clone() for k, v in sd.items()} if rank == 0 else None
    out["nu"] = ({n: opt.adamw.state[p]["exp_avg_sq"].clone()
                  for n, p in tok.net.named_parameters()} if rank == 0 else None)
    return out


def local_loss_case(state, batch, rank, world):
    """This rank's loss over its own rows alone, no reduction: what the
    mean of per-rank losses would be built from."""
    model = build_model(state)
    rows = len(next(iter(batch.values()))["tensor"]) // world
    with torch.no_grad():
        loss, _ = model(rows_of(batch, rank * rows, (rank + 1) * rows), TOKENS, TOKENS, "mod")
    return loss.item()


def eval_case(state, batches):
    """The trainer's run_eval over the global batches, each rank on its rows."""
    from egom2p_torch.cli.run_training import run_eval
    from egom2p_torch.train.egom2p_train import make_eval_step

    model = build_model(state)

    class Batches:
        def __init__(self):
            self.it = iter(batches)

        def __next__(self):
            return next(self.it)

        def close(self):
            pass

    keys = ["loss"] + [f"loss_{m}" for m in sorted(MODS4)]
    return run_eval(Batches, make_eval_step(model, TOKENS, TOKENS, "mod"), "val_", 10, keys,
                    torch.device("cpu"))


def main(job_dir, rank, world):
    job = torch.load(f"{job_dir}/job.pt", weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{job_dir}/rendezvous", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=job.get("timeout_s", 30)))
    torch.set_num_threads(1)
    out = {}
    try:
        for name, case in job["cases"].items():
            kind = case["kind"]
            if kind == "step":
                out[name] = step_case(job["state"], case["batch"], case["accum"], rank, world,
                                      case.get("loss_type", "mod"))
            elif kind == "local_loss":
                out[name] = local_loss_case(job["state"], case["batch"], rank, world)
            elif kind == "eval":
                out[name] = eval_case(job["state"], case["batches"])
            elif kind == "fsdp":
                out[name] = fsdp_case(name, job["state"], case, rank, world)
            elif kind == "vqvae":
                out[name] = vqvae_case(case, rank, world)
            elif kind == "vq":
                out[name] = vq_case(case, rank, world)
            elif kind == "hang":
                # rank 0 enters a collective that rank 1 never does
                if rank == 0:
                    dist.all_reduce(torch.zeros(1))
            else:
                raise ValueError(kind)
        torch.save(out, f"{job_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
