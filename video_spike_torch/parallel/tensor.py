"""Tensor parallelism over the mesh's ``model`` axis.

XLA's SPMD partitioner (GSPMD) has no Python counterpart in the JAX
package: there a kernel placed ``P(None, "model")`` makes XLA split the
layer's output columns over the model axis and insert the collectives.
Here every rank is one process and the collectives are written out, as two
``torch.autograd.Function``s over the ``model`` group:

- :func:`gather_last`: forward, all-gather along the last dimension (the
  blocks in model order); backward, this rank's slice of the gradient (the
  gradient reaching it is the same on every rank of the group);
- :func:`copy_to_model`: forward, identity; backward, all-reduce SUM of the
  input gradient (each rank's is the partial sum over its own columns).

A column-split Dense (:func:`column_dense`) is ``copy_to_model(x) @
kernel_block``, gathered, plus the replicated bias: what GSPMD inserts for
a ``P(None, "model")`` kernel. Its forward and gradients equal the unsplit
layer's up to the order of the sums. The layout of the parameters, and of
the optimizer state that follows them, is the one the sharding rules fix
(``models/vtt.vtt_sharding_rules``): the split kernels' gradients are
their blocks' own, so each rank updates its block in place.

With no group (a model axis of 1, or no process group) both functions are
the identity. ``gather_last.bytes`` and ``copy_to_model.bytes`` count what
each has moved on this rank (the gathered outputs, the f32 input
gradients all-reduced in the backward), for the smoke's traffic figures.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from video_spike_torch.parallel.multihost import gather_dim


def _size_rank(group) -> tuple:
    return dist.get_world_size(group), dist.get_rank(group)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_dim(x, -1, group)

    @staticmethod
    def backward(ctx, grad):
        world, rank = _size_rank(ctx.group)
        n = grad.shape[-1] // world
        return grad[..., rank * n:(rank + 1) * n].contiguous(), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # summed in f32 and rounded once to the gradient's dtype, as the
        # unsplit layer's input gradient leaves its f32 accumulator
        total = grad.float().contiguous()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=ctx.group)
        return total.to(grad.dtype), None


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather `x` along its last dimension over `group` (each rank's
    block in rank order); the gradient is this rank's slice."""
    if group is None:
        return x
    out = _GatherLast.apply(x, group)
    gather_last.bytes += out.numel() * out.element_size()
    return out


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the input gradient is all-reduced over `group`."""
    if group is None:
        return x
    if x.requires_grad:   # f32 words all-reduced in the backward
        copy_to_model.bytes += x.numel() * 4
    return _CopyToModel.apply(x, group)


# the bytes each has moved on this rank (the gathered output; the
# all-reduced input gradient), counted where the collective is set up;
# callers zero and read them
gather_last.bytes = 0
copy_to_model.bytes = 0


def column_dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 dtype: torch.dtype, group) -> torch.Tensor:
    """flax ``nn.Dense(dtype)`` with `kernel` this rank's column block of
    the (in, out) kernel and `bias` the whole (replicated) bias: the block's
    output columns, gathered over `group`, then the bias."""
    y = copy_to_model(x.to(dtype), group) @ kernel.to(dtype)
    return gather_last(y, group) + bias.to(dtype)
