"""The model group's collectives inside autograd: Megatron's conjugate
pair and the gather of a split activation, over `Mesh.model_group`.

JAX's GSPMD inserts these from the tensor-parallel layouts
(parallel/sharding.py); the port calls them where the layouts meet:

  * `copy_to_model`: identity forward, all_reduce backward. It goes
    before a layer that reads a replicated input with a split weight (a
    column layer, a split conv, or the slice a row layer takes of a
    replicated input), so that the input's gradient sums every rank's
    part;
  * `reduce_from_model`: all_reduce forward, identity backward. It goes
    after a row layer, before its (replicated) bias;
  * `gather_from_model`: the blocks of a split activation concatenated
    in model-index order forward (parallel.sharding.gather_model: an
    all_gather, or under gloo on CUDA tensors an exact all_reduce of
    zeros), this rank's block of the gradient backward.

Without the pair, a replicated input's gradient (the planes', the
heads') would keep only this rank's part. Every rank of a model group
runs the same graph, so the backward calls the collectives in one order
on all of them. Each call counts in parallel.sharding.COLLECTIVES under
"model:".
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nvsr_tpu_torch.parallel.sharding import (Mesh, count, gather_model,
                                              model_slice)


def _all_reduce(t, mesh: Mesh):
    dist.all_reduce(t, group=mesh.model_group)
    count("all_reduce", t.numel() * t.element_size(), "model")
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(memory_format=torch.contiguous_format),
                           ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return gather_model(x, dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        return model_slice(grad, ctx.dim, ctx.mesh).contiguous(), None, None


def copy_to_model(x, mesh: Mesh):
    """x as it is; its gradient summed over the model group."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh: Mesh):
    """x summed over the model group; its gradient as it is."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x, mesh: Mesh, dim: int = -1):
    """The model group's blocks of a split x concatenated on `dim`, in
    model-index order; its gradient's block of this rank."""
    return _GatherFromModel.apply(x, mesh, dim % x.dim())
