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

A row-split Dense (:func:`row_dense`) is this rank's column block of the
input times its row block of the kernel, the partial product summed in
f32 over the group (:func:`sum_over_model`: forward all-reduce SUM,
backward identity), then the bias: what GSPMD inserts for a
``P("model", None)`` kernel.

With no group (a model axis of 1, or no process group) these functions are
the identity. ``gather_last.bytes``, ``copy_to_model.bytes`` and
``sum_over_model.bytes`` count what each has moved on this rank (the
gathered outputs, the f32 input gradients all-reduced in the backward, the
f32 partial products all-reduced), for the smoke's traffic figures.

:func:`split_over_model` makes a model run the splits that a placement per
leaf fixes, as far as its layers can, and names the leaves it cannot run
split: the serving session gathers those whole, as GSPMD computes the same
numbers from any layout.
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


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, group):
        total = z.contiguous().clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total

    @staticmethod
    def backward(ctx, grad):
        return grad, None


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


def sum_over_model(z: torch.Tensor, group) -> torch.Tensor:
    """All-reduce SUM of `z` over `group` (each rank's partial product);
    the gradient reaching every rank is passed through as it is."""
    if group is None:
        return z
    sum_over_model.bytes += z.numel() * z.element_size()
    return _SumOverModel.apply(z, group)


# the bytes each has moved on this rank (the gathered output; the
# all-reduced input gradient; the all-reduced partial product), counted
# where the collective is set up; callers zero and read them
gather_last.bytes = 0
copy_to_model.bytes = 0
sum_over_model.bytes = 0

# rows of a row-split kernel upcast to f32 at once (a whole f32 copy of the
# Linear first kernel's block at model = 2 is 1.0 GB)
ROW_CHUNK = 1 << 16


def column_dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 dtype: torch.dtype, group) -> torch.Tensor:
    """flax ``nn.Dense(dtype)`` with `kernel` this rank's column block of
    the (in, out) kernel and `bias` the whole (replicated) bias or its
    block of the same columns: the block's output columns, gathered over
    `group`, and the bias."""
    y = copy_to_model(x.to(dtype), group) @ kernel.to(dtype)
    if bias.shape[-1] == kernel.shape[-1]:      # the bias's block
        return gather_last(y + bias.to(dtype), group)
    return gather_last(y, group) + bias.to(dtype)


def row_dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
              dtype: torch.dtype, group) -> torch.Tensor:
    """flax ``nn.Dense(dtype)`` with `kernel` this rank's row block of the
    (in, out) kernel and `bias` the whole (replicated) bias: `x`'s matching
    column block times the kernel block, both in `dtype`, the product
    summed in f32 (``ROW_CHUNK`` rows at a time) and over `group`, rounded
    to `dtype` once, then the bias. The one-rank GEMM rounds its f32
    accumulator once too; bf16 partials rounded before the sum miss it by
    more than a bf16 ulp. The input gradient is all-reduced over `group`
    (:func:`copy_to_model`)."""
    rank = 0 if group is None else dist.get_rank(group)
    rows = kernel.shape[0]
    xb = copy_to_model(x, group)[..., rank * rows:(rank + 1) * rows]
    z = None
    for r0 in range(0, rows, ROW_CHUNK):
        part = (xb[..., r0:r0 + ROW_CHUNK].to(dtype).float()
                @ kernel[r0:r0 + ROW_CHUNK].to(dtype).float())
        z = part if z is None else z + part
    return sum_over_model(z, group).to(dtype) + bias.to(dtype)


def split_over_model(model: torch.nn.Module, placements) -> tuple:
    """Make `model` (holding, or about to be given, the blocks of its split
    leaves) run what `placements` split over the ``model`` axis, where its
    layers can:

    - a Dense kernel (a module with ``split_dim`` and a 2-D ``kernel``)
      split by rows runs :func:`row_dense`, by columns
      :func:`column_dense`, over the axis's group;
    - the leaves a model names in ``split_heads`` (the VTT's session heads
      and biases), split together on their last axis, make its forward
      compute this rank's block of them and gather the output.

    Returns ``(split, whole)``: the names of the leaves run split, and of
    the split leaves the forward cannot run split (a LayerNorm scale, a
    conv kernel, a bias whose kernel is replicated or split by rows,
    heads split alone or on another axis, any split over ``data``), which
    the caller gathers whole."""
    modules = dict(model.named_modules())
    cut = {k: p for k, p in placements.items() if p.axis is not None}
    split = []
    for k, p in cut.items():
        owner, _, leaf = k.rpartition(".")
        m = modules.get(owner)
        if (p.axis == "model" and leaf == "kernel"
                and hasattr(m, "split_dim") and m.kernel.ndim == 2):
            m.model_group = p.mesh.group("model")
            m.split_dim = p.split_dim(2)
            split.append(k)
            bias = cut.get(f"{owner}.bias")
            if (m.split_dim == 1 and bias is not None
                    and bias.axis == "model" and bias.split_dim(1) == 0):
                split.append(f"{owner}.bias")
    heads = getattr(model, "split_heads", ())
    if heads and all(h in cut and cut[h].axis == "model"
                     and cut[h].split_dim(getattr(model, h).ndim)
                     == getattr(model, h).ndim - 1 for h in heads):
        model.model_group = cut[heads[0]].mesh.group("model")
        split.extend(heads)
    return (tuple(k for k in cut if k in split),
            tuple(k for k in cut if k not in split))
