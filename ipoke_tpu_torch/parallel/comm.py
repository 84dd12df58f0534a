"""Collectives of the mesh layer, as autograd Functions where a gradient
crosses them (Megatron's f/g pair over the ``model`` axis).

On CUDA tensors under gloo PyTorch carries only ``all_reduce`` and
``broadcast``, so these are the only two collectives the mesh layer uses:
a gather is a sum of zero-padded slots.  A group of ``None`` is an axis of
size 1 (a world of one process): every collective is then the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (nothing for a group of None)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def gather_slot(t: torch.Tensor, index: int, size: int, group, dim: int = 0):
    """The concatenation along ``dim`` of the ``size`` ranks' ``t`` (all the
    same shape) over ``group``, this rank's at ``index``: an all-reduce of
    zero-padded slots."""
    if group is None:
        return t
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * size
    out = t.new_zeros(shape)
    out.narrow(dim, index * n, n).copy_(t)
    return all_reduce_(out, group)


class _ReduceFromModel(torch.autograd.Function):
    """g: the sum over the model axis forward, the identity backward (the
    loss downstream runs on every model rank alike)."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """f: the identity forward, the sum over the model axis backward (each
    model rank's use of a replicated value adds a partial gradient)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def reduce_from_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over ``mesh``'s model axis; gradient passed through."""
    return _ReduceFromModel.apply(t, mesh.group("model"))


def copy_to_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` itself; its gradient summed over ``mesh``'s model axis."""
    return _CopyToModel.apply(t, mesh.group("model"))
