"""Host ms a step that the main thread waits in ``vs.producer_wait`` for
the producer thread's next batch, from the program's spans in the traced
slice."""

from benchlib import program_spans


def read(run):
    return program_spans.read_host_ms(run, "producer_wait", self_time=False)
