"""Reduce a ``torch.profiler`` trace of a steady slice to what the
per-layer metrics read: device activity intervals by name, the union of
them (overlapping streams counted once), kernel launches, and the idle
gaps named by the benchmark's host span they fell in."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import intervals

WINDOW_SPAN = "bench.trace_window"


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _ns(ev, what: str) -> float:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return float(fn())
    return float(getattr(ev, f"{what}_us")()) * 1e3


@dataclass
class Trace:
    """Times in seconds on the profiler's clock."""
    device: list = field(default_factory=list)    # (name, start, end)
    host: list = field(default_factory=list)      # (name, start, end)
    window: tuple = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> list:
        """Device activities that are kernel launches (not copies or
        memsets)."""
        return [d for d in self.device
                if not d[0].lower().startswith(("memcpy", "memset"))]

    def busy_s(self, names=None) -> float:
        """Union of device activity inside the window; with ``names`` (a
        predicate on the activity's name) only those activities."""
        acts = [(s, e) for n, s, e in self.device
                if names is None or names(n)]
        return intervals.covered(acts, *self.window)

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = intervals.gaps([(s, e) for _, s, e in self.device],
                              *self.window)
        named = []
        for s, e in sorted(idle, key=lambda g: g[0] - g[1])[:top]:
            named.append([self.span_at(s), e - s])
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": named}

    def span_at(self, t: float) -> str:
        """The innermost benchmark span that holds time ``t``."""
        best = None
        for n, s, e in self.host:
            if n != WINDOW_SPAN and s <= t < e:
                if best is None or e - s < best[2] - best[1]:
                    best = (n, s, e)
        return best[0][len("bench."):] if best else "outside_spans"


def read(prof) -> Trace:
    """A finished profiler's device activities and ``bench.*`` spans."""
    return from_events(prof.profiler.kineto_results.events())


def from_events(events) -> Trace:
    """Split kineto events into device activities and the benchmark's
    spans. A range opened on the host (``record_function``, such as the
    benchmark's ``bench.*`` spans or c10d's ``nccl:all_reduce``) is
    mirrored on the device track as an annotation: it is a span, not
    device work, and is told apart by its name also being a host event's."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, host_names = [], [], set()
    for ev in events:
        start = _ns(ev, "start") * 1e-9
        end = start + _ns(ev, "duration") * 1e-9
        name = ev.name()
        if ev.device_type() == cuda:
            dev.append((name, start, end))
        else:
            host_names.add(name)
            if name.startswith("bench."):
                host.append((name, start, end))
    dev = [d for d in dev
           if d[0] not in host_names and not d[0].startswith("bench.")]
    win = [h for h in host if h[0] == WINDOW_SPAN]
    window = (win[0][1], win[0][2]) if win else (
        (min(d[1] for d in dev), max(d[2] for d in dev)) if dev
        else (0.0, 0.0))
    dev = [d for d in dev if d[2] > window[0] and d[1] < window[1]]
    return Trace(device=dev, host=host, window=window)
