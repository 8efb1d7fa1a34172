"""One training step for every trainer, which writes only its loss,
``loss_fn(leaves) -> (loss, aux)``. :func:`train_step`'s ``core/spans``
phases are ``forward``, ``backward`` (a zero gradient for a leaf the loss
does not reach, as under ``jax.grad``), ``grad_allreduce`` (with a data
group) and ``optimizer``, where :func:`update` alone picks the route: a bare
``AdamW`` steps the leaves and its moments in place (``AdamW.step_``: one
launch of ``csrc/fused_adamw.cu`` on a card, the per-leaf loop on the CPU),
or into new tensors when ``in_place`` is false (``AdamW.step``: one launch
of the same kernel into new storage, the per-leaf loop on the CPU); any
other optimizer, ``tx.update`` and then ``apply_updates`` (or
``apply_updates_sr``) into new tensors."""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from video_spike_torch.core.spans import span
from video_spike_torch.ops.optim import AdamW, apply_updates, is_frozen
from video_spike_torch.parallel.multihost import sum_grads_and_loss


def steps_in_place(tx) -> bool:
    """Whether :func:`update` steps ``tx``'s leaves in place, or with
    ``in_place`` false into new tensors, through the fused AdamW."""
    return type(tx) is AdamW and tx.mu_dtype is None


def update(tx, params: Mapping[str, torch.Tensor],
           grads: Mapping[str, torch.Tensor], opt_state,
           apply_fn: Callable = apply_updates, seed: int = 0,
           in_place: bool = True):
    """``(params, opt_state)`` after one step of ``tx`` on the leaves of
    ``params`` that ``grads`` names: the same dict and state, stepped in
    place, or new ones (see the module's docstring)."""
    trained = {k: params[k] for k in grads}
    if steps_in_place(tx):
        if in_place:
            tx.step_(trained, grads, opt_state)
            return params, opt_state
        stepped, opt_state = tx.step(trained, grads, opt_state)
        return {**params, **stepped}, opt_state
    updates, opt_state = tx.update(grads, opt_state, trained)
    return {**params, **apply_fn(trained, updates, seed)}, opt_state


def train_step(loss_fn: Callable, params: Mapping[str, torch.Tensor],
               opt_state, tx, *,
               leaves: Optional[Mapping[str, torch.Tensor]] = None,
               frozen=(), group=None, reduce: Callable = sum_grads_and_loss,
               apply_fn: Callable = apply_updates, seed: int = 0,
               in_place: bool = True):
    """``(params, opt_state, loss, aux)`` after one step of ``tx``.
    ``leaves`` to differentiate: a model's live parameters, or by default
    detached copies of those of ``params`` outside the ``frozen`` paths.
    ``reduce(grads, loss, group)`` reduces both over a data ``group``; the
    default suits a loss that is one rank's share of the global batch's."""
    with span("forward"):
        if leaves is None:
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items() if not is_frozen(k, frozen)}
        loss, aux = loss_fn(leaves)
    names = list(leaves)
    with span("backward"):
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        with torch.no_grad():
            grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                     for k, g in zip(names, grads)}
    with torch.no_grad():
        loss = loss.detach()
        if group is not None:
            with span("grad_allreduce"):
                grads, loss = reduce(grads, loss, group)
        with span("optimizer"):
            params, opt_state = update(tx, params, grads, opt_state,
                                       apply_fn, seed, in_place)
    return params, opt_state, loss, aux
