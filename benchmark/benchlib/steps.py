"""Per-step times: a CUDA event recorded on the step's stream before the
step and one after it. A step's pair is read once its end has completed,
found by a query after a later step (no sync), and the pair goes back to
a pool: the live events stay few however long the window, and none is
created in the window once set-up has filled the pool. On the CPU (the
tests) the host clock stands in."""

from __future__ import annotations

import collections
import time

import torch


class StepClock:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._pending = collections.deque()
        self._pool = []
        self._ms = []
        self._count = 0

    def wrap(self, fn):
        """``fn`` with every call timed."""

        def timed(*args, **kwargs):
            start = self._mark()
            out = fn(*args, **kwargs)
            end = self._mark()
            self._count += 1
            if self.cuda:
                self._pending.append((start, end))
                self._harvest()
            else:
                self._ms.append((end - start) * 1e3)
            return out

        return timed

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = (self._pool.pop() if self._pool
              else torch.cuda.Event(enable_timing=True))
        ev.record()
        return ev

    def _harvest(self, wait: bool = False) -> None:
        """Read the pending pairs whose end has completed, oldest first
        (every one with ``wait``, after a sync)."""
        while self._pending:
            start, end = self._pending[0]
            if not wait and not end.query():
                return
            self._ms.append(start.elapsed_time(end))
            self._pending.popleft()
            self._pool += (start, end)

    def _settle(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            self._harvest(wait=True)

    def reset(self) -> None:
        self._settle()
        self._ms = []
        self._count = 0

    @property
    def count(self) -> int:
        return self._count

    def times_ms(self) -> list:
        """Every timed call's milliseconds since the last reset
        (synchronizes once)."""
        self._settle()
        return list(self._ms)


class Spans:
    """Host-clock spans the benchmark records around the calls it makes
    into the program (``name -> seconds`` summed), and, while a profiler
    runs, ``torch.profiler.record_function`` ranges of the same names."""

    def __init__(self):
        self.seconds = {}
        self.profiling = False

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, owner: Spans, name: str):
        self.owner, self.name = owner, name
        self._rf = None

    def __enter__(self):
        if self.owner.profiling:
            self._rf = torch.profiler.record_function(f"bench.{self.name}")
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.owner.seconds[self.name] = self.owner.seconds.get(
            self.name, 0.0) + dt
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def quantile(values, q: float) -> float:
    """The ``q`` quantile (0-1) by linear interpolation between order
    statistics (numpy's default); q = 0.5 is the median, 1 the largest."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
