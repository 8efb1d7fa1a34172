"""Process-level runtime setup shared by every CLI.

Counterpart of ``video_spike_tpu/core/runtime.py``. One process drives one
device. Under ``torch.distributed.run`` (``torchrun``) the launcher sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
``MASTER_PORT``; :func:`setup_runtime` then selects the rank's card and
initialises the default process group, as the JAX package initialises its
distributed runtime from ``JAX_COORDINATOR_ADDRESS``. Without those
variables it does nothing, and every helper of ``parallel/`` is a no-op.

- the backend is NCCL when the run's device is ``cuda`` and gloo for
  ``cpu``; ``VST_DIST_BACKEND`` overrides it (gloo with CUDA tensors is how
  several ranks share one card: NCCL refuses two ranks on one device);
- the card is ``LOCAL_RANK`` modulo the visible card count, set with
  ``torch.cuda.set_device`` before the group is initialised.

The JAX package's persistent compilation cache has no counterpart: the
port's CUDA kernels are cached by ``ops/cuda_lib.py`` and nothing else is
compiled ahead of time.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def setup_runtime(device: str | torch.device = "cuda") -> bool:
    """Initialise the default process group from the launcher's
    environment; True when a group is (already) initialised."""
    if not dist.is_available():
        return False
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("a distributed run on cuda asked for, but "
                               "torch.cuda.is_available() is False")
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = os.environ.get("VST_DIST_BACKEND") or (
        "nccl" if on_cuda else "gloo")
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return True


def teardown_runtime() -> None:
    """Leave the process group in order: every rank waits for the others,
    then the groups (the default one and every ``new_group``) are
    destroyed while all peers are still alive, not by the interpreter's
    teardown at exit. A no-op without a group."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
