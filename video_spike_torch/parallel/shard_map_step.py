"""Explicit data-parallel train step.

Counterpart of ``video_spike_tpu/parallel/shard_map_step.py`` (the
``pmean`` inside ``shard_map``): each rank computes the gradients of its
own rows, the gradients and the loss are averaged over the mesh's
``data`` axis by one all-reduce, and every rank applies the same update to
its replica. This is DDP's bucketed all-reduce written out. The trainers
take no ``DistributedDataParallel`` wrapper: their steps are functional
(``torch.func.functional_call`` over a params dict), and the fused readout
step has no gradient for DDP to hook.
"""

from __future__ import annotations

from typing import Callable

import torch

from video_spike_torch.ops.optim import apply_updates
from video_spike_torch.parallel.multihost import sum_across


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
