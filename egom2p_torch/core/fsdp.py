"""Fully sharded data parallelism (ZeRO-3) for the pretraining step.

Port of egom2p_tpu/train/egom2p_train.py:fsdp_spec and of
state_shardings(fsdp=True) (reference: egom2p/utils/fsdp_utils.py:33-116,
which the reference ships unused).  The JAX package annotates shardings
and lets XLA insert the collectives; here they are explicit, by hooks on
the model's modules, over core/distributed.py's process group.

The rule (`fsdp_spec`): a tensor of at least 2^16 elements is split into
`world` equal pieces along its largest dimension divisible by `world`
(the first such in dimension order where two are equally large); smaller
tensors, and those with no such dimension, stay whole on every rank.  The
parameters and both Adam moments follow the same rule: the optimizer is
built on the shards (core/optim.py).

`shard_model(model)` (after the model is made and its weights are the
same on every rank) replaces each sharded parameter in its module by this
rank's piece, a parameter of its own; the full parameter is kept, with its
storage freed.  Between steps a rank holds only its pieces.  Units:
  * every encoder and every decoder block is a unit: a hook before its
    forward all-gathers its sharded parameters into the full ones (one
    collective on the unit's pieces, in a fixed order) and puts them in
    the module; a hook after it frees their storage and puts the pieces
    back.  A hook on the block's output gathers them again when its
    gradient arrives in the backward, before any of the block's backward
    runs; when autograd has accumulated the gradient of every full
    parameter of the block, it frees them.  Under activation checkpointing
    the recomputed forward runs inside the backward, after that gather: it
    finds the weights gathered and frees nothing;
  * the root unit holds the rest (the modality embeddings, the tied 64k
    heads, the norms, the context projection, the mask and register
    tokens): `unshard_root` gathers it before a step's first micro-batch
    (or an eval forward) and `reshard_root` frees it after the last
    backward, since the embeddings run first and the heads last.
The full parameters collect the micro-batches' gradients as the
data-parallel step's parameters do; `reduce_grads_` then sums them over
the ranks with one reduce-scatter per bucket, each rank receiving the sum
of its pieces, and sums the replicated parameters' gradients with
all-reduce (core/distributed.py:all_reduce_grads_).  A full gradient
that is None (a head no row of this rank reached) enters as zeros, so every
rank enters the same collectives with the same sizes.  The sum of two
ranks' fp32 terms does not depend on which collective adds it: two FSDP
ranks give two data-parallel ranks' gradients bitwise.

At one process every large tensor is one piece: the gathers and the
reduce-scatter copy, and the step is the single process's.  Checkpoints
hold full tensors: `full_state_dict` gathers them (a collective: every
rank calls it) and `load_full_state_dict` keeps this rank's piece of each,
so a file moves between FSDP at any world size and data parallelism.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from egom2p_torch.core import distributed

MIN_SHARD_SIZE = 2 ** 16
# elements of the flat buffer of one reduce-scatter (64 MiB of fp32)
BUCKET_ELEMENTS = 1 << 24


def fsdp_spec(shape, n_shard: int, min_size: int = MIN_SHARD_SIZE) -> Optional[int]:
    """The dimension a tensor of `shape` is sharded along over `n_shard`
    ranks, or None: replicated (egom2p_tpu/train/egom2p_train.py:fsdp_spec,
    whose PartitionSpec names "data" at this dimension)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if n < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % n_shard == 0:
            return d
    return None


def _piece(t: torch.Tensor, dim: int, world: int, rank: int) -> torch.Tensor:
    return t.chunk(world, dim)[rank]


class ShardedParam:
    """One sharded parameter: the modules and names it is registered under
    (one parameter may be registered twice: the shared modality
    embeddings), its state-dict keys, the full parameter and this rank's
    piece."""

    def __init__(self, keys: List[str], slots: List[Tuple[nn.Module, str]], full: nn.Parameter,
                 dim: int, world: int, rank: int):
        self.keys, self.slots, self.full, self.dim = keys, slots, full, dim
        self.shape = tuple(full.shape)
        self.shard = nn.Parameter(_piece(full.detach(), dim, world, rank).clone(),
                                  requires_grad=full.requires_grad)
        self.nbytes = full.numel() * full.element_size()

    def register(self, p: nn.Parameter) -> None:
        for module, name in self.slots:
            module._parameters[name] = p


class Unit:
    """The sharded parameters gathered and freed together."""

    def __init__(self, owner: "FSDP", params: List[ShardedParam]):
        self.owner, self.params = owner, params
        self.gathered = False
        self.pending = 0  # full gradients still to accumulate in this backward

    def unshard(self) -> None:
        """All-gather the full parameters (one collective) and register
        them."""
        if self.gathered:
            return
        self.gathered = True
        if not self.params:
            return
        world = self.owner.world
        pieces = self.owner.gather_flat(
            torch.cat([s.shard.detach().reshape(-1) for s in self.params])).view(world, -1)
        offset = 0
        with torch.no_grad():
            for s in self.params:
                n = s.shard.numel()
                s.full.untyped_storage().resize_(s.nbytes)
                # written through .data: autograd's saved references to the
                # full parameter see the weights again, unversioned
                s.full.data.copy_(_assemble(pieces[:, offset:offset + n], s))
                offset += n
        for s in self.params:
            s.register(s.full)
        self.pending = sum(s.full.requires_grad for s in self.params)

    def reshard(self) -> None:
        """Free the full parameters' storage and register the pieces."""
        if not self.gathered:
            return
        self.gathered = False
        for s in self.params:
            s.full.untyped_storage().resize_(0)
            s.register(s.shard)

    def grad_accumulated(self, _p) -> None:
        self.pending -= 1
        if self.pending == 0:
            self.reshard()


def _assemble(pieces: torch.Tensor, s: ShardedParam) -> torch.Tensor:
    """The full tensor from the ranks' flat pieces (world, n): rank r's
    piece is [r n_d, (r + 1) n_d) along the sharded dimension d."""
    world = pieces.shape[0]
    return pieces.reshape(world, *s.shard.shape).movedim(0, s.dim).reshape(s.shape)


def _in_backward() -> bool:
    """Whether autograd is running a backward pass on this thread (where a
    checkpointed block's forward is recomputed): its graph task id is -1
    outside one."""
    return torch._C._current_graph_task_id() != -1


class FSDP:
    """The sharding state of one model (the module docstring)."""

    def __init__(self, model: nn.Module, unit_modules: List[nn.Module]):
        self.world, self.rank = distributed.world_size(), distributed.rank()
        slots: Dict[int, List[Tuple[nn.Module, str]]] = {}
        keys: Dict[int, List[str]] = {}
        for mod_name, module in model.named_modules():
            for pname, p in module._parameters.items():
                if p is not None:
                    slots.setdefault(id(p), []).append((module, pname))
                    keys.setdefault(id(p), []).append(f"{mod_name}.{pname}" if mod_name
                                                      else pname)
        owner = {id(p): i for i, m in enumerate(unit_modules) for p in m.parameters()}
        groups: List[List[ShardedParam]] = [[] for _ in range(len(unit_modules) + 1)]
        self.params: List[ShardedParam] = []
        for p in model.parameters():
            dim = fsdp_spec(p.shape, self.world)
            if dim is not None:
                s = ShardedParam(keys[id(p)], slots[id(p)], p, dim, self.world, self.rank)
                self.params.append(s)
                groups[owner.get(id(p), len(unit_modules))].append(s)
        self.by_key = {k: s for s in self.params for k in s.keys}
        self.by_shard = {id(s.shard): s for s in self.params}
        self.units = [Unit(self, g) for g in groups[:-1]]
        self.root = Unit(self, groups[-1])
        for unit in self.units + [self.root]:
            unit.gathered = True  # the full weights are in place: reshard frees them
            unit.reshard()
        for module, unit in zip(unit_modules, self.units):
            if unit.params:
                self._hook(module, unit)

    def _hook(self, module: nn.Module, unit: Unit) -> None:
        def pre_forward(_module, _args):
            unit.unshard()

        def pre_backward(grad):
            unit.unshard()
            return grad

        def post_forward(_module, _args, output):
            if _in_backward():
                return  # a checkpointed block's recompute: its backward follows
            if torch.is_grad_enabled() and output.requires_grad:
                output.register_hook(pre_backward)
            unit.reshard()

        module.register_forward_pre_hook(pre_forward)
        module.register_forward_hook(post_forward)
        for s in unit.params:
            if s.full.requires_grad:
                s.full.register_post_accumulate_grad_hook(unit.grad_accumulated)

    # ----------------------------------------------------------- collectives
    def gather_flat(self, t: torch.Tensor) -> torch.Tensor:
        return distributed.all_gather_flat(t) if distributed.initialized() else t.clone()

    def gather(self, t: torch.Tensor, s: ShardedParam) -> torch.Tensor:
        """The full tensor of a piece `t` shaped as `s`'s (its parameter's
        piece, or an optimizer moment of it): a collective."""
        return _assemble(self.gather_flat(t.detach().contiguous().reshape(-1))
                         .view(self.world, -1), s)

    def piece(self, full: torch.Tensor, s: ShardedParam) -> torch.Tensor:
        """This rank's piece of a full tensor shaped as `s`'s."""
        return _piece(full, s.dim, self.world, self.rank)

    # -------------------------------------------------------------- the step
    def unshard_root(self) -> None:
        self.root.unshard()

    def reshard_root(self) -> None:
        self.root.reshard()

    def after_backward(self) -> None:
        """After a micro-batch's backward: every block unit freed, one whose
        parameters received no gradient too."""
        for unit in self.units:
            unit.reshard()

    def sharded(self, p: torch.Tensor) -> Optional[ShardedParam]:
        """The sharded parameter whose piece `p` is, or None."""
        return self.by_shard.get(id(p))

    def reduce_grads_(self, replicated: List[nn.Parameter]) -> None:
        """The step's gradients summed over the ranks: each sharded
        parameter's full gradient reduce-scattered into its piece's .grad
        (and the full gradient freed), the replicated ones all-reduced."""
        bucket: List[ShardedParam] = []

        def flush():
            grads = [s.full.grad if s.full.grad is not None
                     else torch.zeros(s.shape, dtype=s.shard.dtype, device=s.shard.device)
                     for s in bucket]
            # rank r's segment: its piece of every gradient of the bucket
            flat = torch.cat([_piece(g, s.dim, self.world, r).reshape(-1)
                              for r in range(self.world) for s, g in zip(bucket, grads)])
            del grads
            out = (distributed.reduce_scatter_flat(flat) if distributed.initialized()
                   else flat)
            for s, g in zip(bucket, out.split([s.shard.numel() for s in bucket])):
                s.shard.grad = g.view_as(s.shard)
                s.full.grad = None
            bucket.clear()

        size = 0
        for s in self.params:
            if bucket and size + s.full.numel() > BUCKET_ELEMENTS:
                flush()
                size = 0
            bucket.append(s)
            size += s.full.numel()
        if bucket:
            flush()
        distributed.all_reduce_grads_(replicated)


def shard_model(model: nn.Module) -> FSDP:
    """Shard `model` in place over the process group (the module
    docstring); its weights must be the same on every rank.  The units are
    its encoder and decoder blocks.  Returns the state, which
    state_of(model) gives too."""
    units = [*getattr(model, "encoder", []), *getattr(model, "decoder", [])]
    state = FSDP(model, units)
    model.__dict__["_fsdp"] = state
    return state


def state_of(model: nn.Module) -> Optional[FSDP]:
    """The FSDP state of a model that shard_model sharded, else None."""
    return model.__dict__.get("_fsdp")


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with full tensors: the sharded parameters
    gathered (a collective: every rank calls it), each once (a parameter
    registered under two keys gives both one tensor)."""
    state = state_of(model)
    sd = model.state_dict()
    if state is None:
        return sd
    gathered: Dict[int, torch.Tensor] = {}
    out = {}
    for k, t in sd.items():
        s = state.by_key.get(k)
        if s is None:
            out[k] = t
            continue
        if id(s) not in gathered:
            gathered[id(s)] = state.gather(t, s)
        out[k] = gathered[id(s)]
    return out


def full_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Every state-dict key's full shape."""
    state = state_of(model)
    by_key = state.by_key if state is not None else {}
    return {k: by_key[k].shape if k in by_key else tuple(v.shape)
            for k, v in model.state_dict().items()}


def load_full_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor],
                         strict: bool = True) -> None:
    """Load a state dict of full tensors, each sharded parameter taking this
    rank's piece (model.load_state_dict where the model is not sharded)."""
    state = state_of(model)
    if state is not None:
        sd = {k: state.piece(v, state.by_key[k]) if k in state.by_key else v
              for k, v in sd.items()}
    model.load_state_dict(sd, strict=strict)
