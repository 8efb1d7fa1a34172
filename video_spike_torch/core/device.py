"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never drops to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for `device`; raises when a CUDA device is asked
    for and none is present.

    ``cuda`` without an index becomes the calling thread's current card
    (the rank's card once ``core/runtime.setup_runtime`` has set it), so a
    tensor moved to the returned device from any thread lands there: a
    thread the process starts (a producer, a writer) begins on card 0."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for but torch.cuda.is_available() is "
            f"False; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
