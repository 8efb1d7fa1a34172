"""Device-idle ms a step while the main thread's innermost span was
``vs.optimizer``: the gaps between the device trace's activities in the
traced slice, where they overlap that span's self time."""

from benchlib import program_spans


def read(run):
    return program_spans.read_idle_ms(run, "optimizer")
