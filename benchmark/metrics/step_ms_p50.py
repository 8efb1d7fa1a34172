"""Median training step in the window, ms: CUDA events before and after
each step on its stream, read after the window."""

from benchlib.steps import quantile


def read(run):
    return quantile(run.step_ms, 0.5) if run.step_ms else None
