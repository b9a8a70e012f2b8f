"""Data-parallel execution on torch.distributed (counterpart of
nvsr_tpu/parallel/sharding.py).

JAX runs one controller over a device mesh and lets GSPMD insert the
collectives. The port runs one process per rank (launched by torchrun,
or by torch.multiprocessing in tests) and makes them explicit, under
JAX's contract:

  * every rank holds the same host seed and the same replicated
    parameters (`replicate` broadcasts them from rank 0);
  * a batch's rays are sharded contiguously on axis 0, in the order of
    JAX's P("data"): rank r holds rows [r*n/W, (r+1)*n/W)
    (`data_sharding`, `shard_rays`);
  * gradients are averaged over the global batch (`all_reduce_`, one
    collective per dtype bucket).

Only `broadcast` and `all_reduce` are called: NCCL and gloo both carry
them on CUDA tensors (gloo's all_gather and reduce on CUDA tensors
cannot be relied on), and two ranks that share one card can only run
gloo. Decisions the host takes (when to evaluate, save or stop) travel
on a gloo group over CPU tensors (`Mesh.cpu_group`), so agreeing on them
never makes the host wait for the card.

`COLLECTIVES` counts the calls by kind and the bytes each kind moved.

Tensor parallelism (`model_parallel > 1`, JAX's decoder_tp_shardings and
plane_sr_tp_shardings) is not ported: ROADMAP Queue 1 #2 (b).
"""

from __future__ import annotations

import collections
import dataclasses
import pickle
from typing import Optional

import torch
import torch.distributed as dist

# calls and bytes by kind: "all_reduce" and "broadcast" on the device
# group, "control" on the host group
COLLECTIVES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel world: its rank, the world
    size, the group that carries the device collectives, the group that
    carries the host's (gloo over CPU tensors; the same group under
    gloo), and the device the rank computes on."""
    rank: int
    world: int
    group: object
    cpu_group: object
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"data": self.world, "model": 1}


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, *,
              group=None, device=None) -> Mesh:
    """The ('data', 'model') mesh of the initialized process group:
    'data' is the world, 'model' 1. n_devices, when given, must be the
    world size. device: where this rank computes (default: the current
    card under NCCL, the CPU otherwise). Collective: every rank calls
    it."""
    if model_parallel > 1:
        raise NotImplementedError(
            "model_parallel > 1 (tensor parallelism) is not ported yet: "
            "ROADMAP Queue 1 #2 (b)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of "
                         f"{world}")
    backend = dist.get_backend(group)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    cpu_group = group if backend == "gloo" else dist.new_group(
        backend="gloo")
    return Mesh(dist.get_rank(group), world, group, cpu_group,
                torch.device(device))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(v, it) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return None if tree is None else next(it)


def _buckets(leaves) -> dict:
    """Leaf indices by dtype, in leaf order."""
    out = {}
    for i, t in enumerate(leaves):
        out.setdefault(t.dtype, []).append(i)
    return out


def _flat(leaves, idx):
    return torch.cat([leaves[i].reshape(-1) for i in idx])


def all_reduce_(tree, op=dist.ReduceOp.SUM, *, mesh: Mesh):
    """Reduce every tensor of `tree` over the mesh: its leaves
    flattened into one contiguous buffer per dtype, one all_reduce per
    buffer. Returns the tree's structure with the reduced values (views
    into the buffers)."""
    leaves = _leaves(tree)
    out = [None] * len(leaves)
    for dtype, idx in _buckets(leaves).items():
        buf = _flat(leaves, idx)
        dist.all_reduce(buf, op=op, group=mesh.group)
        COLLECTIVES["all_reduce"] += 1
        COLLECTIVES["all_reduce_bytes"] += buf.numel() * buf.element_size()
        for i, part in zip(idx, buf.split([leaves[i].numel()
                                           for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return _rebuild(tree, iter(out))


def broadcast_(tree, src: int, *, mesh: Mesh):
    """Overwrite every tensor of `tree` with rank `src`'s, in place: one
    broadcast per dtype buffer. Returns `tree`."""
    leaves = _leaves(tree)
    for dtype, idx in _buckets(leaves).items():
        buf = _flat(leaves, idx)
        dist.broadcast(buf, group=mesh.group, group_src=src)
        COLLECTIVES["broadcast"] += 1
        COLLECTIVES["broadcast_bytes"] += buf.numel() * buf.element_size()
        for i, part in zip(idx, buf.split([leaves[i].numel()
                                           for i in idx])):
            leaves[i].copy_(part.view(leaves[i].shape))
    return tree


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """Rank 0's values in every rank's tensors of `tree` (in place, so
    an optimizer holding them keeps them): the counterpart of placing a
    pytree with JAX's replicated sharding. Returns `tree`."""
    return broadcast_(tree, 0, mesh=mesh)


def broadcast_object(obj, src: int, *, mesh: Mesh):
    """Rank `src`'s picklable `obj` on every rank, over the host group
    (its length, then its bytes)."""
    if mesh.rank == src:
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                   dtype=torch.uint8)
        size = torch.tensor([payload.numel()], dtype=torch.int64)
    else:
        size = torch.zeros(1, dtype=torch.int64)
    dist.broadcast(size, group=mesh.cpu_group, group_src=src)
    if mesh.rank != src:
        payload = torch.empty(int(size), dtype=torch.uint8)
    dist.broadcast(payload, group=mesh.cpu_group, group_src=src)
    COLLECTIVES["control"] += 2
    return obj if mesh.rank == src else pickle.loads(payload.numpy()
                                                     .tobytes())


def agree(mesh: Optional[Mesh], *flags):
    """Rank 0's values of `flags` (numbers) on every rank, in one
    broadcast over the host group; the flags themselves without a
    mesh. Host decisions (evaluate, save, stop) go through it, so no
    rank takes a branch that another skips."""
    if mesh is None:
        return flags
    t = torch.tensor([float(f) for f in flags], dtype=torch.float64)
    dist.broadcast(t, group=mesh.cpu_group, group_src=0)
    COLLECTIVES["control"] += 1
    return tuple(type(f)(v) for f, v in zip(flags, t.tolist()))


def decoder_tp_shardings(params, mesh: Mesh):
    """JAX's tensor-parallel decoder layout: not ported yet."""
    raise NotImplementedError(
        "tensor-parallel decoders are not ported yet: ROADMAP Queue 1 "
        "#2 (b)")


def plane_sr_tp_shardings(params, mesh: Mesh):
    """JAX's channel-sharded plane-SR layout: not ported yet."""
    raise NotImplementedError(
        "the channel-sharded plane SR is not ported yet: ROADMAP Queue 1 "
        "#2 (b)")


def data_sharding(mesh: Mesh, n: int) -> tuple:
    """The rows [lo, hi) of an n-row batch that this rank holds, in the
    order of JAX's P("data"). n must divide by the world size, as JAX
    requires of a sharded axis: the port does not pad."""
    if n % mesh.world:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{mesh.world} ranks")
    per = n // mesh.world
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_rays(mesh: Mesh, rays):
    """This rank's rows of a RayBundle (every field sliced on axis 0)."""
    lo, hi = data_sharding(mesh, rays.origins.shape[0])
    return type(rays)(*[None if f is None else f[lo:hi] for f in rays])
