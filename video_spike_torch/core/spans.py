"""Named host spans inside the training step and the input pipeline, on
the profiler's clock.

``span(name)`` is a context manager. It records only while a
``torch.profiler`` records in this process; there is no other switch:

- off, it returns one shared no-op object made at import: no allocation,
  no clock read, no profiler range;
- on, it opens a profiler range named ``"vs." + name``, so every chrome
  trace the profiler writes shows it, and keeps
  ``Span(name, thread, start_ns, end_ns)`` in a ring of the newest ``CAP``
  spans. Times are ``time.time_ns()``, the clock the profiler's events
  carry, read just before the range opens and closes, so the device
  trace's idle gaps can be put down to the span the host was in. Spans on
  one thread nest, so a reader finds a span's children by their
  intervals.

A profiler started on one thread does not see the ranges opened on
another, but the ring keeps every thread's spans while the process
traces. ``recorded()`` returns a copy of the ring and ``clear()`` empties
it.

``backward_span(name, output, inputs)`` spans autograd's backward of what
led from ``inputs`` to ``output``: a hook on ``output``'s gradient opens
it and a hook on the gradients of all of ``inputs`` closes it. On a card
autograd runs the backward on its own thread, so the span lands there.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler
# the range ``torch.profiler.record_function`` opens, entered from C: the
# clock read and the profiler's own are one call apart, with nothing
# allocated between them that the garbage collector tracks, so no
# collection can fall between the two and move the span off its range
from torch._C._profiler import _RecordFunctionFast as _Range

PREFIX = "vs."
CAP = 100_000


class Span(NamedTuple):
    name: str
    thread: int
    start_ns: int
    end_ns: int


_RING: collections.deque = collections.deque(maxlen=CAP)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _On:
    __slots__ = ("name", "range", "start")

    def __init__(self, name: str):
        self.name = name
        self.range = _Range(PREFIX + name)

    def __enter__(self):
        self.start = time.time_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.range.__exit__(*exc)
        _RING.append(Span(self.name, threading.get_ident(), self.start, end))
        return False


def span(name: str):
    """A span named ``name`` while a profiler records, else ``OFF``."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _On(name)


def recorded() -> list:
    """The spans in the ring, oldest first (a copy)."""
    return list(_RING)


def clear() -> None:
    _RING.clear()


def backward_span(name: str, output: torch.Tensor, inputs) -> None:
    """While a profiler records and ``output`` needs a gradient, a span
    named ``name`` over the backward from ``output``'s gradient to those
    of every tensor of ``inputs``; else nothing. The hooks return None, so
    no gradient changes."""
    if not _profiler._is_profiler_enabled or not output.requires_grad:
        return
    opened = []

    def open_(grad):
        s = _On(name)
        s.__enter__()
        opened.append(s)

    def close(grads):
        if opened:
            opened.pop().__exit__(None, None, None)

    output.register_hook(open_)
    torch.autograd.graph.register_multi_grad_hook(tuple(inputs), close)
