"""Device time of the activities launched inside a named host range, from
the events of a ``torch.profiler`` trace.

Each device activity (a kernel, copy or memset) carries the correlation
id of the host op that launched it (``linked_correlation_id``); that op
is a host event with the same ``correlation_id`` and a thread. An
activity counts when its op began inside a range of the given name on
the op's own thread: the program's ``vs.attention`` spans are such
ranges, on the main thread for the forward and on autograd's thread for
the backward. Ranges the profiler mirrors on the device track are
annotations, not work, and are left out as ``benchlib/trace.py`` leaves
them out. Times are seconds on the profiler's clock."""

from __future__ import annotations

import bisect
from typing import NamedTuple, Optional

import torch


class Event(NamedTuple):
    """The parts of a kineto event read here (``from_kineto``)."""
    name: str
    device: bool          # on the device track
    thread: int
    start: float
    end: float
    correlation: int      # a host op's own id (0 for other events)
    linked: int           # the launching op's id (0 for host ops)


def from_kineto(events) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in events:
        start = ev.start_ns() * 1e-9
        out.append(Event(ev.name(), ev.device_type() == cuda,
                         ev.start_thread_id(), start,
                         start + ev.duration_ns() * 1e-9,
                         ev.correlation_id(), ev.linked_correlation_id()))
    return out


def launched_in(events, name: str, window) -> Optional[dict]:
    """``{"s": device seconds, "forward_s", "backward_s", "ranges"}`` of
    the activities launched inside ranges named ``name``, clipped to
    ``window``: ``forward_s`` is the share of the thread whose first range
    began first (the forward precedes its backward), ``backward_s`` that
    of every other thread. None when no range of that name ran in the
    window."""
    lo, hi = window
    ranges, ops, host_names = {}, {}, set()
    for ev in events:
        if ev.device:
            continue
        host_names.add(ev.name)
        if ev.name == name and ev.end > lo and ev.start < hi:
            ranges.setdefault(ev.thread, []).append((ev.start, ev.end))
        elif ev.linked == 0 and ev.correlation:
            ops[ev.correlation] = (ev.thread, ev.start)
    if not ranges:
        return None
    for r in ranges.values():
        r.sort()
    starts = {t: [s for s, _ in r] for t, r in ranges.items()}
    first = min(ranges, key=lambda t: ranges[t][0][0])
    by_thread = {t: 0.0 for t in ranges}
    for ev in events:
        if not ev.device or ev.name in host_names or not ev.linked:
            continue
        op = ops.get(ev.linked)
        if op is None or op[0] not in ranges:
            continue
        thread, t0 = op
        i = bisect.bisect_right(starts[thread], t0) - 1
        if i < 0 or t0 > ranges[thread][i][1]:
            continue
        s, e = max(ev.start, lo), min(ev.end, hi)
        if e > s:
            by_thread[thread] += e - s
    forward = by_thread[first]
    total = sum(by_thread.values())
    return {"s": total, "forward_s": forward, "backward_s": total - forward,
            "ranges": sum(len(r) for r in ranges.values())}
