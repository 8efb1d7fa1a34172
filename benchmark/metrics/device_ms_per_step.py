"""Device time a step, ms: the union of every kernel, copy and memset
interval in the traced slice (streams that overlap counted once) over its
steps. The profiler slows the host, not the card, so this reads the same
with tracing on; the work the card does for a step."""


def read(run):
    if run.trace is None or not run.trace_steps or not run.trace.device:
        return None
    return 1e3 * run.trace.busy_s() / run.trace_steps
