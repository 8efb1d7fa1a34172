"""Graceful-preemption support: catch SIGTERM/SIGINT, finish the current
epoch, checkpoint, exit cleanly.

The reference has no failure handling at all — a SLURM preemption kills the
job and loses everything since the last manual save (SURVEY.md §5.3). Here
every trainer wraps its epoch loop in :func:`graceful_stop`; the cluster's
TERM signal (SLURM sends it ``GraceTime`` before the kill) flips a flag the
loop checks at the next epoch boundary, the trainer writes ``model_last``
(params + optimizer state + epoch, the true-resume checkpoint), and
``--resume`` continues where it left off.
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Iterator


class StopFlag:
    """Mutable stop signal shared with the registered handlers."""

    def __init__(self) -> None:
        self.stop = False
        self.signum: int | None = None

    def __bool__(self) -> bool:
        return self.stop


@contextlib.contextmanager
def graceful_stop(log=None, signals=(signal.SIGTERM, signal.SIGINT)
                  ) -> Iterator[StopFlag]:
    """Context manager: yields a :class:`StopFlag` that turns truthy when a
    listed signal arrives. Handlers are restored on exit. A second signal
    falls through to the previous (default) handler, so a double Ctrl-C
    still kills a hung run. No-op off the main thread (Python only allows
    signal registration there)."""
    flag = StopFlag()
    prev = {}

    def handler(signum, frame):
        if flag.stop:   # second signal: defer to the original behavior
            previous = prev.get(signum)
            if callable(previous):
                previous(signum, frame)
                return
            raise KeyboardInterrupt
        flag.stop = True
        flag.signum = signum
        if log is not None:
            log.info(f"received signal {signum}: finishing the current "
                     f"epoch, then checkpointing model_last")

    is_main = threading.current_thread() is threading.main_thread()
    if is_main:
        for s in signals:
            try:
                prev[s] = signal.signal(s, handler)
            except (ValueError, OSError):  # restricted environments
                pass
    try:
        yield flag
    finally:
        if is_main:
            for s, old in prev.items():
                signal.signal(s, old)
