"""Data- and tensor-parallel execution on torch.distributed
(counterpart of nvsr_tpu/parallel/sharding.py).

JAX runs one controller over a device mesh and lets GSPMD insert the
collectives. The port runs one process per rank (launched by torchrun,
or by torch.multiprocessing in tests) and makes them explicit, under
JAX's contract:

  * the ('data', 'model') mesh of W ranks with model_parallel M is
    JAX's reshape(W // M, M): rank r has data index r // M and model
    index r % M (`make_mesh`). The ranks of one data index form its
    model group, the ranks of one model index its data group;
  * every rank holds the same host seed and the same replicated
    parameters (`replicate` broadcasts them from rank 0); under M > 1
    each rank then keeps its model index's slices of the decoders and
    the plane-SR convolutions (`decoder_tp_shardings`,
    `plane_sr_tp_shardings`, `shard_tree`; `gather_tree` goes back), and
    parallel/tensor.py's autograd Functions carry the model group's
    collectives;
  * a batch's rays are sharded contiguously on axis 0 over the data
    index, in the order of JAX's P("data"): data index d of D holds rows
    [d*n/D, (d+1)*n/D), and the ranks of one model group hold the same
    rows (`data_sharding`, `shard_rays`);
  * gradients are averaged over the data group (`all_reduce_`, one
    collective per dtype bucket).

The collectives are `broadcast` and `all_reduce`, which NCCL and gloo
both carry on CUDA tensors, and the model group's gather
(`gather_model`): an all_gather under NCCL and on CPU tensors, and
under gloo on CUDA tensors (gloo's all_gather there cannot be relied
on; two ranks that share one card can only run gloo) an all_reduce of
a zero-filled buffer, which moves about twice a ring all_gather's
bytes. Decisions the host takes (when to evaluate, save or stop) travel
on a gloo group over CPU tensors (`Mesh.cpu_group`), so agreeing on them
never makes the host wait for the card.

`COLLECTIVES` counts the calls by kind and the bytes each kind moved,
in all and by the group that carried them ("world:", "data:",
"model:" keys).
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
    """One rank's view of the ('data', 'model') mesh: its rank, the world
    size, the group that carries the device collectives over the world,
    the group that carries the host's (gloo over CPU tensors; the same
    group under gloo), the device the rank computes on, and the model
    axis: its size, the data group (the ranks of this model index; the
    world when it is 1) and the model group (the ranks of this data
    index; None when it is 1)."""
    rank: int
    world: int
    group: object
    cpu_group: object
    device: torch.device
    model_parallel: int = 1
    data_group: object = None
    model_group: object = None

    def __post_init__(self):
        if self.data_group is None:
            object.__setattr__(self, "data_group", self.group)

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    @property
    def data_size(self) -> int:
        return self.world // self.model_parallel

    @property
    def shape(self) -> dict:
        return {"data": self.data_size, "model": self.model_parallel}


def tensor_parallel(mesh: Optional[Mesh]) -> bool:
    """Whether `mesh` splits the model (model_parallel > 1)."""
    return mesh is not None and mesh.model_parallel > 1


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, *,
              group=None, device=None) -> Mesh:
    """The ('data', 'model') mesh of the initialized process group: the
    world reshaped to (world // model_parallel, model_parallel), as
    JAX's make_mesh reshapes its devices. n_devices, when given, must be
    the world size; model_parallel must divide it (ValueError, where JAX
    asserts). device: where this rank computes (default: the current
    card under NCCL, the CPU otherwise). Collective: every rank calls it,
    and every rank creates every model and data group, in one order."""
    if model_parallel < 1 or (n_devices is not None
                              and n_devices % model_parallel):
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"a mesh of {n_devices} ranks")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size(group)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a world of "
                         f"{world}")
    if world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world of {world} ranks")
    backend = dist.get_backend(group)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    cpu_group = group if backend == "gloo" else dist.new_group(
        backend="gloo")
    rank = dist.get_rank(group)
    data_group = model_group = None
    if model_parallel > 1:
        m = model_parallel
        for d in range(world // m):
            g = dist.new_group(list(range(d * m, (d + 1) * m)))
            if d == rank // m:
                model_group = g
        for i in range(m):
            g = dist.new_group(list(range(i, world, m)))
            if i == rank % m:
                data_group = g
    return Mesh(rank, world, group, cpu_group, torch.device(device),
                model_parallel, data_group, model_group)


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


def count(kind: str, nbytes: int, axis: str):
    """One collective of `kind` that moved `nbytes` over the `axis`
    group ("world", "data" or "model"), in COLLECTIVES."""
    for key in (kind, f"{axis}:{kind}"):
        COLLECTIVES[key] += 1
        COLLECTIVES[key + "_bytes"] += nbytes


def _group(mesh: Mesh, axis: str):
    return {"world": mesh.group, "data": mesh.data_group,
            "model": mesh.model_group}[axis]


def all_reduce_(tree, op=dist.ReduceOp.SUM, *, mesh: Mesh,
                axis: str = "world"):
    """Reduce every tensor of `tree` over the mesh's `axis` group (the
    world, the data group or the model group): its leaves flattened into
    one contiguous buffer per dtype, one all_reduce per buffer. Returns
    the tree's structure with the reduced values (views into the
    buffers)."""
    leaves = _leaves(tree)
    out = [None] * len(leaves)
    for dtype, idx in _buckets(leaves).items():
        buf = _flat(leaves, idx)
        dist.all_reduce(buf, op=op, group=_group(mesh, axis))
        count("all_reduce", buf.numel() * buf.element_size(), axis)
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
        count("broadcast", buf.numel() * buf.element_size(), "world")
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


def _linear_tp(shard_out: bool) -> dict:
    """A linear layer's split: column (w[:, slice], b[slice]) or row
    (w[slice, :], b replicated)."""
    return {"w": 1, "b": 0} if shard_out else {"w": 0, "b": None}


def decoder_tp_shardings(params, mesh: Mesh):
    """The tensor-parallel layout of a triplane decoder pytree (JAX's
    decoder_tp_shardings): the trunk layers alternate column and row
    splits over 'model' (Megatron's pattern: layer i even splits its
    output features, i odd its input features), the heads fc_alpha,
    fc_rgb and fc_feat are replicated. A layout has the params'
    structure, each leaf the axis it is split on or None (replicated);
    shard_tree and gather_tree read it."""
    def member(m):
        out = {branch: [_linear_tp(i % 2 == 0)
                        for i in range(len(m[branch]))]
               for branch in ("density", "rgb")}
        for head in ("fc_alpha", "fc_rgb", "fc_feat"):
            if head in m:
                out[head] = {"w": None, "b": None}
        return out

    return {"members": [member(m) for m in params["members"]]}


def plane_sr_tp_shardings(params, mesh: Mesh):
    """The tensor-parallel layout of a plane-SR pytree (JAX's
    plane_sr_tp_shardings): every 4-D (OIHW) conv weight split on its
    output channels, and its bias with it; every other leaf (the input
    normalization, SRResNet's BatchNorm and PReLU) replicated."""
    def walk(tree):
        if isinstance(tree, dict):
            if "w" in tree and getattr(tree["w"], "ndim", 0) == 4:
                return {k: 0 if k in ("w", "b") else walk(v)
                        for k, v in tree.items()}
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return None

    return walk(params)


def zip_layout(tree, layout):
    """(leaf, axis) pairs of `tree` in leaf order, matched to the
    layout by dict key and list index."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in zip_layout(v, layout[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v, a in zip(tree, layout) for x in zip_layout(v, a)]
    return [] if tree is None else [(tree, layout)]


def model_slice(t, dim: int, mesh: Mesh):
    """This rank's block of `t` on `dim`: the model index's contiguous
    1/M of it, as a NamedSharding lays blocks out in mesh order. A size
    that M does not divide is refused (ValueError, as JAX's device_put
    refuses it)."""
    size = t.shape[dim]
    m = mesh.model_parallel
    if size % m:
        raise ValueError(f"axis {dim} of a {tuple(t.shape)} tensor does "
                         f"not split over model_parallel={m}")
    per = size // m
    return t.narrow(dim, mesh.model_index * per, per)


def shard_tree(full, layout, mesh: Mesh):
    """The sharded form of `full`: each split leaf replaced by a
    contiguous copy of this rank's block (model_slice), each replicated
    leaf kept. Returns a new tree of `full`'s structure."""
    pairs = zip_layout(full, layout)
    return _rebuild(full, iter(
        t if a is None else model_slice(t, a, mesh).contiguous()
        for t, a in pairs))


# all_gather_into_tensor's newer name, where the installed torch has it
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def gather_model(t, dim: int, mesh: Mesh):
    """The model group's blocks of a split `t` concatenated on `dim` in
    model-index order (the inverse of model_slice). Collective over the
    model group: one all_gather under NCCL or on CPU tensors; under gloo
    on CUDA tensors an all_reduce(SUM) of zeros of the full shape with
    this rank's block written in (exact: x + 0)."""
    m = mesh.model_parallel
    if t.device.type == "cpu" or dist.get_backend(mesh.model_group) == "nccl":
        t = t.contiguous()
        out = t.new_empty((m * t.shape[0],) + tuple(t.shape[1:]))
        _ALL_GATHER(out, t, group=mesh.model_group)
        count("all_gather", out.numel() * out.element_size(), "model")
        return out.view(m, *t.shape).movedim(0, dim).flatten(
            dim, dim + 1).contiguous()
    shape = list(t.shape)
    shape[dim] *= m
    full = t.new_zeros(shape)
    model_slice(full, dim, mesh).copy_(t)
    dist.all_reduce(full, group=mesh.model_group)
    count("all_reduce", full.numel() * full.element_size(), "model")
    return full


@torch.no_grad()
def gather_tree(sharded, layout, mesh: Mesh):
    """The full form of a sharded tree: each split leaf's blocks
    gathered over the model group (gather_model), each replicated leaf
    as it is. Collective over the model group."""
    return _rebuild(sharded, iter(
        t if a is None else gather_model(t, a, mesh)
        for t, a in zip_layout(sharded, layout)))


def data_sharding(mesh: Mesh, n: int) -> tuple:
    """The rows [lo, hi) of an n-row batch that this rank holds: its data
    index's block, in the order of JAX's P("data") (the ranks of one
    model group hold the same rows). n must divide by the data axis, as
    JAX requires of a sharded axis: the port does not pad."""
    d = mesh.data_size
    if n % d:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{d} data ranks")
    per = n // d
    return mesh.data_index * per, (mesh.data_index + 1) * per


def shard_rays(mesh: Mesh, rays):
    """This rank's rows of a RayBundle (every field sliced on axis 0)."""
    lo, hi = data_sharding(mesh, rays.origins.shape[0])
    return type(rays)(*[None if f is None else f[lo:hi] for f in rays])
