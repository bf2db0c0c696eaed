"""One rank of the port's data-parallel checks, run as its own process.

    python tests/torch_dist_ranks.py JOB_DIR RANK WORLD

Reads JOB_DIR/job.pt (the model's weights and the global batches, written
by tests/test_torch_distributed.py), joins the gloo group through a file
under JOB_DIR, runs the job's cases on its rows of each global batch and
writes what it computed to JOB_DIR/rank{RANK}.pt.  Imports the port only,
never JAX, so that a rank starts in a few seconds.
"""
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

NAME = "egom2p_tiny_6e_6d_swiglu_nobias"
MODS4 = ("tok_cam", "tok_depth", "tok_gaze", "tok_rgb")
TOKENS = 32


def build_model(state):
    from egom2p_torch.data.modality_info import make_scaled_modality_info
    from egom2p_torch.models.egom2p import create_model

    model = create_model(NAME, MODS4, MODS4, modality_info=make_scaled_modality_info(),
                         compute_dtype="float32")
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
