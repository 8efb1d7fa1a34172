"""Device ms a step of the activities launched inside the program's
``vs.attention`` spans, forward (the main thread) and backward (autograd's
thread), from the traced slice (``benchlib/launched.py``). Nothing where
the program has no such span, the runner kept no launch links or no
device activity was linked (a run without a card)."""


def read(run):
    got = getattr(run, "attention", None)
    if not got or not got["s"] or not run.trace_steps:
        return None
    return 1e3 * got["s"] / run.trace_steps
