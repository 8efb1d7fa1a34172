"""Faults planted in the program's timed path, to show that a run with
the path broken comes out not correct (the tests) and to read the
numbers such a run gives at the cell's size (``calibrate.py --fault``).
Each is called with the trainer after set-up has built it, before the
benchmark wraps its step. None is used by a run of the benchmark."""

from __future__ import annotations

import torch


def state_unchanged(trainer):
    """The step computes its loss and returns the state it was given."""
    if hasattr(trainer, "_step_fn"):
        model, crit = trainer.model, trainer.criterion

        def step(params, opt_state, inputs, ap, n_valid, seed):
            with torch.no_grad():
                out = torch.func.functional_call(model, params, (inputs,))
                return params, opt_state, crit(out, ap, n_valid)

        trainer._step_fn = step
        return
    real = trainer._train_step

    def train_step(trip):
        saved = {k: v.clone() for k, v in trainer.params.items()}
        state = trainer.opt_state
        logs = real(trip)
        trainer._set_params(saved)
        trainer.opt_state = state
        return logs

    trainer._train_step = train_step


def half_batch(trainer):
    """Half of every batch left out; the mean is over the rest."""
    if hasattr(trainer, "_step_fn"):
        real = trainer._step_fn

        def step(params, opt_state, inputs, ap, n_valid, seed):
            h = inputs.shape[0] // 2
            return real(params, opt_state, inputs[:h], ap[:h],
                        n_valid // 2, seed)

        trainer._step_fn = step
        return
    real = trainer._train_step
    trainer._train_step = lambda trip: real(trip[:, : trip.shape[1] // 2])


def no_exchange(trainer):
    """The exchange between ranks left out: the step is built without its
    data-parallel group, so each rank updates from its own rows alone."""
    from video_spike_torch.ops import fused_readout as fr

    trainer._step_fn = fr.make_fused_linear_step(
        trainer.model, trainer.tx, trainer.schedule, trainer.criterion,
        trainer._apply_updates, group=None)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, no_exchange)}
