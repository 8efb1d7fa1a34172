"""Host ms a step in ``vs.optimizer`` less its children (the optimizer's
update and its application to every leaf), from the program's spans in
the traced slice."""

from benchlib import program_spans


def read(run):
    return program_spans.read_host_ms(run, "optimizer")
