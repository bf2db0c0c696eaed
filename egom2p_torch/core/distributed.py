"""Process groups for data-parallel training across processes.

Port of egom2p_tpu/core/distributed.py (reference: egom2p/utils/dist.py:
78-100) over torch.distributed.  torchrun starts one process per device and
names it in the environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); `init_distributed_mode` forms the group from it, over NCCL for
CUDA devices and gloo for the CPU.  A process started without that
environment runs alone with no group, as the JAX package's single host
does; a caller that has formed a group already (two ranks sharing one card
over gloo, say) keeps its own.  A rendezvous that fails raises: a process
of several never carries on alone.

Without a group every helper here acts for one process: rank 0 of 1, a
barrier that returns, metrics that come back as they went in.
"""
from __future__ import annotations

import builtins
import contextlib
import datetime
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

# torch's own default for gloo and NCCL groups
DEFAULT_TIMEOUT_S = 1800.0


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def local_rank() -> int:
    """This process's device index on its node (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def is_main_process() -> bool:
    return rank() == 0


def init_distributed_mode(device_type: str = "cuda",
                          timeout_s: Optional[float] = None) -> Dict[str, int]:
    """Form the process group that torchrun's environment names (NCCL for
    `device_type` "cuda", gloo for "cpu"); a no-op without RANK and
    WORLD_SIZE in the environment (one process) or with a group formed
    already; torchrun's one process of one forms a group too.  Raises
    when the environment is incomplete or the rendezvous fails within
    `timeout_s`.  Returns {"rank", "world_size", "local_rank"}."""
    world = os.environ.get("WORLD_SIZE")
    if not initialized() and world is not None and (int(world) > 1 or "RANK" in os.environ):
        if not dist.is_available():
            raise RuntimeError("WORLD_SIZE is set but this torch has no torch.distributed")
        missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"WORLD_SIZE is set but {missing} are not: launch with torchrun")
        backend = "nccl" if device_type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(local_rank())
        dist.init_process_group(
            backend, init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            timeout=datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S))
    return {"rank": rank(), "world_size": world_size(), "local_rank": local_rank()}


def collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the current CUDA
    device for NCCL, the CPU for gloo."""
    if initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if not initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the group, in place; `t` itself without a group.
    The result is the same on every rank."""
    if initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """The mean over processes of host scalars, each process contributing
    its value once (egom2p_tpu/core/distributed.py:all_reduce_metrics;
    reference: egom2p/utils/logger.py:52-63); floats, the same on every
    rank.  Every rank must call it with the same keys."""
    keys = list(metrics)
    if not keys or not initialized():
        return {k: float(v) for k, v in metrics.items()}
    t = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                     device=collective_device())
    all_reduce_sum_(t)
    return dict(zip(keys, (t / world_size()).tolist()))


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` stacked along dim 0 in rank order (each rank's
    tensor has the same shape): the process-ordered global array, on
    `t`'s device (gathered where the group's collectives run)."""
    if not initialized() or world_size() == 1:
        return t
    local = t.to(collective_device()).contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(local) for _ in range(world_size())]
    dist.all_gather(parts, local)
    return torch.cat(parts, dim=0).to(t.device)


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Rank `src`'s parameters and buffers copied into every rank's
    `module`, in place."""
    if not initialized():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src)


@contextlib.contextmanager
def main_prints_only():
    """Within the block, print() prints on rank 0 only (another rank's
    print(..., force=True) still prints), as the reference's
    setup_for_distributed (egom2p/utils/dist.py) does for a whole run."""
    if is_main_process():
        yield
        return
    real = builtins.print

    def quiet(*args, force: bool = False, **kwargs):
        if force:
            real(*args, **kwargs)

    builtins.print = quiet
    try:
        yield
    finally:
        builtins.print = real
