"""Host ms a step in ``vs.forward`` less its children (the model, the
input transform and the loss dispatched), from the program's spans in the
traced slice."""

from benchlib import program_spans


def read(run):
    return program_spans.read_host_ms(run, "forward")
