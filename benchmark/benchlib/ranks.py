"""The benchmark's few exchanges between ranks of a multi-card cell: the
window's end decided by rank 0, and the readings every rank took gathered
to rank 0, which prints. One process is rank 0 of a world of 1."""

from __future__ import annotations

import torch.distributed as dist

MASK63 = (1 << 63) - 1


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def gather(obj) -> list:
    """Every rank's ``obj``, in rank order, on every rank."""
    if not active():
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def from_rank0(obj):
    """Rank 0's ``obj`` on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def data_seed(seed: int, r: int, n: int) -> int:
    """The seed of rank ``r``'s own trials: the run's seed in one process,
    a distinct stream per rank otherwise."""
    return seed if n == 1 else (seed * 1_000_003 + r + 1) & MASK63
