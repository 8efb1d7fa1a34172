"""The program's own spans (``video_spike_torch.core.spans``: ``vs.step``
and, inside it, ``vs.forward``, ``vs.backward``, ``vs.optimizer``, ...) in
a traced slice, for the per-layer metrics that read them.

The spans are read from the program's ring after the run, clipped to the
slice's window (``Trace.window``, the same clock in seconds), and taken on
the main thread: the one that ran the ``vs.step`` spans. A step is one
``vs.step`` span in the slice. A span's self time is its duration less
what its children on the same thread cover. Every function returns None
where there is nothing to read: a program without the spans, a run
without a trace, or (for the idle time) no device trace."""

from __future__ import annotations

from typing import NamedTuple, Optional

from . import intervals

STEP = "step"


class Span(NamedTuple):
    """One span of the main thread clipped to the window, in seconds;
    ``self_s`` is its interval less its direct children's, as
    ``[(start, end), ...]``."""
    name: str
    start: float
    end: float
    self_s: list


def recorded() -> Optional[list]:
    """The program's recorded spans as ``(name, thread, start_s, end_s)``,
    or None where the program has no span facility."""
    try:
        from video_spike_torch.core import spans
    except ImportError:
        return None
    return [(s.name, s.thread, s.start_ns * 1e-9, s.end_ns * 1e-9)
            for s in spans.recorded()]


def main_spans(raw, window) -> Optional[list]:
    """The main thread's spans of ``raw`` (``(name, thread, start, end)``
    in seconds) clipped to ``window``, each with its self intervals; None
    without a ``vs.step`` span in the window."""
    if not raw:
        return None
    lo, hi = window
    clipped = [(n, t, max(s, lo), min(e, hi)) for n, t, s, e in raw
               if min(e, hi) > max(s, lo)]
    steps = [t for n, t, _, _ in clipped if n == STEP]
    if not steps:
        return None
    main = max(set(steps), key=steps.count)
    mine = sorted(((n, s, e) for n, t, s, e in clipped if t == main),
                  key=lambda s: (s[1], -s[2]))
    # spans on one thread nest: a stack of the open ones finds each
    # span's direct children
    children = [[] for _ in mine]
    open_ = []
    for i, (_, s, e) in enumerate(mine):
        while open_ and mine[open_[-1]][2] <= s:
            open_.pop()
        if open_:
            children[open_[-1]].append((s, e))
        open_.append(i)
    return [Span(n, s, e, intervals.gaps(kids, s, e))
            for (n, s, e), kids in zip(mine, children)]


def _spans(run) -> Optional[list]:
    if getattr(run, "trace", None) is None:
        return None
    return main_spans(recorded(), run.trace.window)


def step_count(spans) -> int:
    return sum(s.name == STEP for s in spans)


def ms_per_step(spans, name: str, self_time: bool = True) -> Optional[float]:
    """Host ms a step in ``vs.<name>``: its self time, or with
    ``self_time=False`` its whole duration; None where no such span ran."""
    mine = [s for s in spans if s.name == name]
    if not mine:
        return None
    total = sum(sum(e - s for s, e in sp.self_s) if self_time
                else sp.end - sp.start for sp in mine)
    return 1e3 * total / step_count(spans)


def overlap(a, b) -> float:
    """Length of the intersection of the unions of two interval lists."""
    a, b = intervals.union(a), intervals.union(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_by_span(trace, spans) -> dict:
    """Device-idle seconds in the window by the main thread's innermost
    span at the time (``None``: outside every span)."""
    idle = intervals.gaps([(s, e) for _, s, e in trace.device],
                          *trace.window)
    out = {}
    for sp in spans:
        out[sp.name] = out.get(sp.name, 0.0) + overlap(idle, sp.self_s)
    tops = [(sp.start, sp.end) for sp in spans]
    out[None] = sum(e - s for s, e in idle) - overlap(idle, tops)
    return out


def idle_ms_per_step(trace, spans, name: str) -> Optional[float]:
    """Device-idle ms a step while the main thread's innermost span was
    ``vs.<name>``; None without a device trace or such a span."""
    if trace is None or not trace.device or not spans or \
            not any(s.name == name for s in spans):
        return None
    return 1e3 * idle_by_span(trace, spans)[name] / step_count(spans)


def read_host_ms(run, name: str, self_time: bool = True) -> Optional[float]:
    spans = _spans(run)
    return None if spans is None else ms_per_step(spans, name, self_time)


def read_idle_ms(run, name: str) -> Optional[float]:
    return idle_ms_per_step(getattr(run, "trace", None), _spans(run), name)
