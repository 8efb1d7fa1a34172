"""Host ms a step in ``vs.backward`` less its children (autograd's
gradient of every leaf), from the program's spans in the traced slice."""

from benchlib import program_spans


def read(run):
    return program_spans.read_host_ms(run, "backward")
