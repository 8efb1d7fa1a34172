"""Rich console logging with a colored header.

Capability parity with the reference's ``src/utils/log_utils.py:16-144``: a
`logging(header=..., header_color=...)` object exposing info/warning/error/
debug. In a multi-process run only rank 0 prints; errors print on every
rank (they matter for debugging a run that spans processes).
"""

from __future__ import annotations

import logging as pylogging
import sys

import torch.distributed as dist

try:
    from rich.logging import RichHandler

    _HAVE_RICH = True
except ImportError:  # pragma: no cover
    _HAVE_RICH = False


_CONFIGURED = False
_RICH_ACTIVE = False


def _is_primary() -> bool:
    """Rank 0, or no process group (read at each call: a logger may be made
    before the group is initialised)."""
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def _configure_root(level=pylogging.INFO) -> None:
    global _CONFIGURED, _RICH_ACTIVE
    if _CONFIGURED:
        return
    handlers = []
    if _HAVE_RICH and sys.stderr.isatty():
        handlers.append(RichHandler(rich_tracebacks=True, show_path=False))
        fmt = "%(message)s"
        _RICH_ACTIVE = True
    else:
        handlers.append(pylogging.StreamHandler())
        fmt = "%(asctime)s %(levelname)s %(message)s"
    pylogging.basicConfig(level=level, format=fmt, handlers=handlers, force=True)
    _CONFIGURED = True


class logging:  # noqa: N801 — keep the reference's lowercase class name
    """Named logger with a decorative header, rank-0 gated."""

    def __init__(self, header: str = "[vstorch]",
                 header_color: str = "#7aa2f7", level=pylogging.INFO):
        _configure_root(level)
        self.header = header
        self.header_color = header_color
        self._log = pylogging.getLogger("video_spike_torch")
        self._log.setLevel(level)

    def _fmt(self, msg: str) -> str:
        if _RICH_ACTIVE:
            return f"[{self.header_color}]{self.header}[/] {msg}"
        return f"{self.header} {msg}"

    def info(self, msg: str) -> None:
        if _is_primary():
            self._log.info(self._fmt(msg), extra={"markup": True})

    def warning(self, msg: str) -> None:
        if _is_primary():
            self._log.warning(self._fmt(msg), extra={"markup": True})

    def error(self, msg: str) -> None:
        self._log.error(self._fmt(msg), extra={"markup": True})

    def debug(self, msg: str) -> None:
        if _is_primary():
            self._log.debug(self._fmt(msg), extra={"markup": True})
