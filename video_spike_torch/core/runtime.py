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
  ``torch.cuda.set_device`` before the group is initialised. Under NCCL
  every rank then publishes its card (host and UUID) in the group's store
  and reads the others': two ranks on one card raise, naming both (NCCL
  takes one rank per card; ranks that share one run gloo);
- every collective of the group times out after ``VST_DIST_TIMEOUT``
  seconds (default :data:`DEFAULT_TIMEOUT_S`, against NCCL's ten minutes):
  a rank blocked in a collective on a peer that died is then ended by the
  backend's watchdog within that bound. Under ``torch.distributed.run`` the
  launcher stops the peers of a failed rank sooner;
- barriers name this rank's card under NCCL (``device_ids``), so none
  guesses a card from the global rank.

A rank leaves in order. Left to the interpreter's exit, a gloo rank can
abort after its work is done (``terminate called without an active
exception``): a gloo worker thread (``ProcessGroupGloo::runLoop``) that
drops the last reference to a tensor holding a Python object needs the GIL,
and once finalization has begun Python ends such a thread with
``pthread_exit``, whose unwinding through a ``noexcept`` frame terminates
the process. So:

- :func:`setup_runtime` registers an ``atexit`` hook that destroys the
  process groups without a barrier (a rank that raised must not wait for
  peers that will not come), while the interpreter still runs: the
  counterpart of the shutdown JAX registers for its distributed runtime;
- :func:`exit_rank` is how a rank's entry point ends: barrier, destroy the
  groups, join background checkpoint writes, flush the output streams and
  the logging handlers, then ``os._exit``, so no finalization runs at all;
  :func:`run_rank` runs an entry point's ``main`` and leaves through it,
  with code 1 and the traceback printed when ``main`` raised;
- a rank that fails under NCCL leaves without destroying its groups:
  destroying a communicator while the peers wait in a collective blocks
  until they are ended, so the failed rank's exit code, which lets
  ``torch.distributed.run`` stop the peers, would come only after the
  group's timeout. ``os._exit`` releases the communicators with the
  process.

The JAX package's persistent compilation cache has no counterpart: the
port's CUDA kernels are cached by ``ops/cuda_lib.py`` and nothing else is
compiled ahead of time.
"""

from __future__ import annotations

import atexit
import logging
import os
import socket
import sys
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist


DEFAULT_TIMEOUT_S = 300.0


def dist_timeout() -> timedelta:
    """How long a collective may wait for its peers: ``VST_DIST_TIMEOUT``
    seconds, else :data:`DEFAULT_TIMEOUT_S`."""
    return timedelta(seconds=float(os.environ.get("VST_DIST_TIMEOUT")
                                   or DEFAULT_TIMEOUT_S))


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
                            world_size=world, timeout=dist_timeout())
    atexit.register(_release_groups)
    if backend == "nccl" and world > 1:
        check_one_rank_per_card(_default_store(), rank, world,
                                _card_name(torch.cuda.current_device()))
    return True


def _card_name(index: int) -> str:
    """This host's name and the card's UUID: what tells two cards apart
    whatever each process's ``CUDA_VISIBLE_DEVICES``."""
    uuid = torch.cuda.get_device_properties(index).uuid
    return f"{socket.gethostname()}/{uuid}"


def _default_store():
    return dist.distributed_c10d._get_default_store()


def check_one_rank_per_card(store, rank: int, world: int, card: str) -> None:
    """Publish this rank's `card` in `store` and read every rank's; raise
    naming the ranks when another rank drives the same card (NCCL takes
    one rank per card). A collective over the store: every rank calls
    it."""
    store.set(f"vst_card/{rank}", card)
    cards = [store.get(f"vst_card/{r}").decode() for r in range(world)]
    shared = [r for r, c in enumerate(cards) if c == card and r != rank]
    if shared:
        raise RuntimeError(
            f"ranks {rank} and {shared[0]} both drive card {card}: NCCL "
            f"takes one rank per card; start at most one rank a card (or "
            f"set VST_DIST_BACKEND=gloo for ranks that share one)")


def _has_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _nccl() -> bool:
    return dist.get_backend() == "nccl"


def _release_groups() -> None:
    """Destroy every process group now, with no barrier; a no-op without
    a group (the ``atexit`` hook of :func:`setup_runtime`). Under NCCL
    after an exception nobody caught, the process ends at once with code
    1 instead (the communicators go with it)."""
    if not _has_group():
        return
    if _nccl() and getattr(sys, "last_value", None) is not None:
        _flush()
        os._exit(1)
    dist.destroy_process_group()


def teardown_runtime() -> None:
    """Leave the process group in order: every rank waits for the others,
    then the groups (the default one and every ``new_group``) are
    destroyed while all peers are still alive, not by the interpreter's
    teardown at exit. A no-op without a group."""
    if _has_group():
        barrier()
        dist.destroy_process_group()


def barrier() -> None:
    """``dist.barrier`` over the default group, on this rank's card under
    NCCL."""
    if _nccl():
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _flush() -> None:
    for stream in (sys.stdout, sys.stderr):
        try:
            stream.flush()
        except (AttributeError, OSError, ValueError):
            pass
    logging.shutdown()


def exit_rank(code: int = 0) -> None:
    """End this rank's process with `code`, without the interpreter's
    teardown: after a clean run (`code` 0) every rank meets at a barrier
    before the groups are destroyed; otherwise gloo groups are destroyed
    at once and NCCL groups are left to the process's end (their peers may
    wait in a collective). Background checkpoint writes are joined first (a
    failed one turns code 0 into 1), then stdout, stderr and the logging
    handlers are flushed and the process ends with ``os._exit``. Without a
    process group it returns and the interpreter exits as usual."""
    if not _has_group():
        return
    try:
        from video_spike_torch.train.checkpoint import wait_for_checkpoints

        if not wait_for_checkpoints(raise_errors=False):
            code = code or 1
        if code == 0:
            teardown_runtime()
        elif not _nccl():
            _release_groups()
    except BaseException:          # noqa: BLE001  (reported, then exit)
        traceback.print_exc()
        code = code or 1
    finally:
        _flush()
        os._exit(code)


def run_rank(main, *args, **kwargs):
    """Run an entry point's ``main(*args, **kwargs)``; under a process
    group the rank then leaves through :func:`exit_rank`: code 0 once main
    returned, 1 once it raised (its traceback printed first). Without a
    group, and for ``SystemExit`` and ``KeyboardInterrupt`` (the ``atexit``
    hook then releases the groups), main's result or exception passes
    through."""
    try:
        out = main(*args, **kwargs)
    except Exception:
        if not _has_group():
            raise
        traceback.print_exc()
        exit_rank(1)
    exit_rank(0)
    return out
