"""Explicit data-parallel train step.

Counterpart of ``video_spike_tpu/parallel/shard_map_step.py`` (the
``pmean`` inside ``shard_map``): each rank computes the gradients of its
own rows, the gradients and the loss are averaged over the mesh's
``data`` axis by one all-reduce, and every rank applies the same update to
its replica. This is DDP's bucketed all-reduce written out. The trainers
take no ``DistributedDataParallel`` wrapper: their steps are functional
(``torch.func.functional_call`` over a params dict), and the fused readout
step has no gradient for DDP to hook.

:func:`make_tensor_train_step` is the step under a (data, model) mesh
with tensor-sharded parameters (the JAX package's ``DCN_MODE=tensor``).
"""

from __future__ import annotations

from typing import Callable

import torch

from video_spike_torch.ops.optim import apply_updates
from video_spike_torch.parallel.multihost import (
    sum_across,
    sum_grads_and_loss,
)


def make_shard_map_train_step(model_apply: Callable, criterion: Callable,
                              tx, mesh, axis: str = "data"):
    """``step(params, opt_state, x, ap) -> (params, opt_state, loss)`` on
    this rank's rows ``x``, ``ap``.

    ``model_apply(params, x)`` -> outputs; ``criterion(outputs, targets)``
    -> scalar loss; ``tx`` an optimizer of ``ops/optim``. Params and the
    optimizer state are replicated: every rank ends the step with the same
    values.
    """
    group = mesh.group(axis)
    n = mesh.shape[axis]

    def step(params, opt_state, x, ap):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = criterion(model_apply(leaves, x), ap)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        with torch.no_grad():
            reduced = sum_across({**grads, "__loss__": loss.detach()[None]},
                                 group)
            loss = reduced.pop("__loss__")[0] / n
            grads = {k: g / n for k, g in reduced.items()}
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, loss

    return step


def make_tensor_train_step(loss_fn: Callable, tx, mesh):
    """``step(params, opt_state, *batch) -> (params, opt_state, loss)``
    with tensor-sharded params: the train step of the JAX package's
    ``dcn_trainer_smoke._tensor_sharded`` / ``__graft_entry__._dryrun_body``
    (``jax.value_and_grad`` then ``tx.update`` under the production
    sharding rules).

    ``loss_fn(params, *batch)`` -> this rank's share of the global loss
    (its data block's rows, divided by the global count) through a model
    whose split layers run over the ``model`` group
    (``models/vtt.split_over_model``). ``params`` holds each rank's blocks
    of the split leaves and the whole replicated ones; ``tx`` updates them
    as they are, so its state is split like its leaves.

    Every leaf's gradient and the loss are summed over the ``data`` group
    (a split leaf within its model column, the ranks holding the same
    block). A replicated leaf's gradient needs no collective over
    ``model``: the split layers all-reduce their input gradients and
    gather their outputs, so it is the same on every rank of a model row.
    """
    group = mesh.group("data")

    def step(params, opt_state, *batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = loss_fn(leaves, *batch)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        with torch.no_grad():
            grads, loss = sum_grads_and_loss(grads, loss.detach(), group)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, loss

    return step
