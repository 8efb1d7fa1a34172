"""Share of the traced slice in which no device activity ran, %: 100
less the union of every kernel, copy and memset interval (streams that
overlap counted once) over the slice."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 - 100.0 * run.trace.busy_s() / run.trace.window_s
