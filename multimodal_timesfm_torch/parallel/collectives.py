"""The model axis's two collectives as autograd functions (Megatron-LM's f and g).

A column-parallel GEMM reads a replicated input and writes this rank's block
of the output features; a row-parallel GEMM reads a block of the input
features and writes a partial sum of the whole output (Shoeybi et al., 2019,
"Megatron-LM"). Two operators keep the forward and backward right:

  * :func:`copy_to_model` (f): identity forward, all-reduce backward. Where a
    replicated tensor enters per-rank work, each rank's backward holds only
    its own share of the gradient; the sum over the axis is the whole of it.
  * :func:`reduce_from_model` (g): all-reduce forward, identity backward. The
    partial sums of a row-parallel GEMM add up to its output.

The sums run in fp32 whatever the tensor's dtype. A :class:`ModelAxis` is
shared, not copied, by ``copy.deepcopy`` (a process group cannot be copied).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


class ModelAxis:
    """This rank's line along the mesh's model axis: its group, its index, the axis size."""

    def __init__(self, group: Any, rank: int, size: int) -> None:
        self.group, self.rank, self.size = group, rank, size

    def __deepcopy__(self, memo: dict) -> "ModelAxis":
        return self

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous block of dim ``dim`` of ``x`` (size divisible by the axis)."""
        chunk = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * chunk, chunk)


def _sum32(x: torch.Tensor, group: Any) -> torch.Tensor:
    y = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=group)
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _sum32(g, ctx.axis.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
        return _sum32(x, axis.group)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        ctx.dtype = inputs[0].dtype

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model axis (f)."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The fp32 sum of ``x`` over the model axis; the gradient passes as it is (g)."""
    return _ReduceFromModel.apply(x, axis)


def scatter_to_model(x: torch.Tensor, axis: ModelAxis, dim: int = -1) -> torch.Tensor:
    """This rank's block of dim ``dim`` of a replicated ``x``, with the whole gradient of
    ``x`` summed over the axis (f, then a local slice)."""
    return axis.block(copy_to_model(x, axis), dim)
