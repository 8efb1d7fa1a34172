"""95th percentile of every training step in the window, ms, where the
card is idle most of the window and the tail is the host's."""

from benchlib.steps import quantile


def read(run):
    return quantile(run.step_ms, 0.95) if run.step_ms else None
