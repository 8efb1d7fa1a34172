"""Explicit data-parallel train step.

Counterpart of ``video_spike_tpu/parallel/shard_map_step.py`` (the
``pmean`` inside ``shard_map``): each rank computes the gradients of its
own rows, the gradients and the loss are averaged over the mesh's
``data`` axis by one all-reduce, and every rank applies the same update to
its replica. This is DDP's bucketed all-reduce written out. The trainers
take no ``DistributedDataParallel`` wrapper: their steps are functional
(``torch.func.functional_call`` over a params dict), and the fused readout
step has no gradient for DDP to hook.

The step is ``ops/step.py``'s: a bare AdamW updates ``params`` and its
state in place.
"""

from __future__ import annotations

from typing import Callable

from video_spike_torch.ops.step import train_step
from video_spike_torch.parallel.multihost import sum_grads_and_loss


def make_shard_map_train_step(model_apply: Callable, criterion: Callable,
                              tx, mesh, axis: str = "data"):
    """``step(params, opt_state, x, ap) -> (params, opt_state, loss)`` on
    this rank's rows ``x``, ``ap``.

    ``model_apply(params, x)`` -> outputs; ``criterion(outputs, targets)``
    -> scalar loss; ``tx`` an optimizer of ``ops/optim``. Params and the
    optimizer state are replicated: every rank ends the step with the same
    values.
    """
    group, n = mesh.group(axis), mesh.shape[axis]

    def mean(grads, loss, group):
        grads, loss = sum_grads_and_loss(grads, loss, group)
        return {k: g / n for k, g in grads.items()}, loss / n

    def step(params, opt_state, x, ap):
        params, opt_state, loss, _ = train_step(
            lambda leaves: (criterion(model_apply(leaves, x), ap), None),
            params, opt_state, tx, group=group, reduce=mean)
        return params, opt_state, loss

    return step
