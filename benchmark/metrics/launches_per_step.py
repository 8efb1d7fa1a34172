"""Kernel launches a step in the traced slice (copies and memsets not
counted)."""


def read(run):
    if run.trace is None or not run.trace_steps:
        return None
    n = len(run.trace.kernels())
    return n / run.trace_steps if n else None
