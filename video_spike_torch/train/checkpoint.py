"""Checkpoint save/load (counterpart of ``video_spike_tpu/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file of plain containers (dicts, lists,
tuples, ints, floats and CPU tensors), written to a temporary file beside
the target, fsynced and renamed over it, so a kill at any point leaves
either the old or the new complete checkpoint. Artifact names keep the
reference's ``model_best`` / ``model_last`` contract with a ``.pt`` suffix.

Mid-training flushes run in the background (``save_checkpoint_async``): the
device-to-host fetch (``parallel_device_get``: pinned buffers filled on a
side stream) and the write run on a thread while the step loop goes on;
``wait_for_checkpoints`` joins them and re-raises the first failure.
"""

from __future__ import annotations

import logging
import os
import threading
from pathlib import Path
from typing import Any, Optional

import torch

# One lock for every checkpoint write in this process, whichever thread
# (the trainer's loop, a background flush) issues it: two writers of one
# path would share its temporary file name. Only the write serializes; the
# device-to-host fetch of a background save happens before the lock and
# overlaps.
_SAVE_LOCK = threading.Lock()


def _path(directory: str | Path, name: str) -> Path:
    return Path(directory) / f"{name}.pt"


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def to_cpu(tree: Any) -> Any:
    """Copy every tensor in a nested dict/list/tuple to the CPU."""
    return _map(lambda t: t.detach().to("cpu", copy=True), tree)


def to_device(tree: Any, device) -> Any:
    return _map(lambda t: t.to(device), tree)


def copy_into(live: Any, loaded: Any, where: str = "") -> Any:
    """``loaded``, each tensor copied into the tensor at its place in the
    dict tree ``live``, which must have its shape, dtype and device (else
    ``ValueError``); what is not a tensor passes through. A step that
    updates ``live`` in place then writes nothing of ``loaded``."""
    if isinstance(loaded, dict):
        live = live if isinstance(live, dict) else {}
        return {k: copy_into(live.get(k), v, f"{where}/{k}")
                for k, v in loaded.items()}
    if not isinstance(loaded, torch.Tensor):
        return loaded
    want = (loaded.shape, loaded.dtype, loaded.device)
    if not isinstance(live, torch.Tensor) or (
            live.shape, live.dtype, live.device) != want:
        raise ValueError(f"{where}: no live tensor of {want} to load into")
    with torch.no_grad():
        return live.copy_(loaded)


def snapshot(tree: Any) -> Any:
    """A copy of every tensor on its own device (for a background save of
    tensors the next step updates in place)."""
    return _map(lambda t: t.detach().clone(), tree)


def _write(path: Path, cpu_tree: Any) -> str:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    with _SAVE_LOCK:
        try:
            with open(tmp, "wb") as f:
                torch.save(cpu_tree, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if tmp.exists():
                tmp.unlink()
    return str(path)


def save_checkpoint(directory: str | Path, name: str, tree: Any) -> str:
    """Write `tree` (tensors may live on any device) to ``directory/name.pt``
    atomically: temporary file, fsync, rename."""
    return _write(_path(directory, name), to_cpu(tree))


def parallel_device_get(tree: Any, ready: Optional[torch.cuda.Event] = None
                        ) -> Any:
    """`tree` with every tensor on the CPU: CUDA tensors are copied into
    pinned host buffers on a side stream that first waits on `ready` (an
    event recorded on the compute stream when the save was asked for;
    recorded here when None), so the copies neither stall the training
    kernels queued after that point nor read tensors before they are
    written; CPU tensors are copied. Returns once the copies are done."""
    cuda = []
    _map(lambda t: cuda.append(t) if t.is_cuda else None, tree)
    if not cuda:
        return to_cpu(tree)
    device = cuda[0].device
    if ready is None:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
    side = torch.cuda.Stream(device)
    side.wait_event(ready)

    def fetch(t):
        if not t.is_cuda:
            return t.detach().to("cpu", copy=True)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            t.record_stream(side)
            host.copy_(t.detach(), non_blocking=True)
        return host

    out = _map(fetch, tree)
    side.synchronize()
    return out


_PENDING: dict = {}
_ASYNC_ERRORS: list = []


def save_checkpoint_async(directory: str | Path, name: str, tree: Any,
                          after=None) -> None:
    """Save `tree` in the background for mid-training flushes.

    The caller hands tensors it will not update in place (the best stash,
    or a ``snapshot`` of the live ones): the fetch to pinned host memory and
    the write run on a thread while training continues. A second save to
    the same path joins the first; call :func:`wait_for_checkpoints` before
    reading the artifact or exiting — it re-raises the first failure of
    any background save, so a flush that died cannot silently leave the
    artifact missing.

    ``after`` (optional, no arguments) runs on the background thread only
    after the checkpoint landed on disk — e.g. a sidecar that must never
    stamp a checkpoint that failed to write. Its failure surfaces at the
    next :func:`wait_for_checkpoints` like a save's."""
    key = str(_path(directory, name).resolve())
    prev = _PENDING.get(key)
    if prev is not None:
        prev.join()
    ready = None
    devices = set()
    _map(lambda t: devices.add(t.device) if t.is_cuda else None, tree)
    if devices:
        # the copies must see every kernel queued so far on the compute
        # stream, and nothing queued after
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(next(iter(devices))))

    def work():
        try:
            _write(_path(directory, name), parallel_device_get(tree, ready))
            if after is not None:
                after()
        except BaseException as e:  # noqa: BLE001 — surfaced at the join
            _ASYNC_ERRORS.append(e)

    t = threading.Thread(target=work, daemon=True, name=f"ckpt:{name}")
    _PENDING[key] = t
    t.start()


def wait_for_checkpoints(raise_errors: bool = True) -> bool:
    """Join every in-flight background save (call before exit or before
    reading an artifact).

    Raises the first error any background save hit. Preemption paths pass
    ``raise_errors=False`` (a warning instead): their job is to write
    ``model_last`` inside the grace window, and a best flush that died must
    not abort that. Returns True when every joined save succeeded, so a
    caller that does not raise can re-save synchronously."""
    for t in list(_PENDING.values()):
        t.join()
    _PENDING.clear()
    if _ASYNC_ERRORS:
        err = _ASYNC_ERRORS[0]
        _ASYNC_ERRORS.clear()
        if raise_errors:
            raise RuntimeError("background checkpoint save failed") from err
        logging.getLogger("video_spike_torch").warning(
            "background checkpoint save failed (continuing): %r", err)
        return False
    return True


def checkpoint_exists(directory: str | Path, name: str) -> bool:
    return _path(directory, name).is_file()


def load_checkpoint(directory: str | Path, name: str, device="cpu") -> Any:
    """Read ``directory/name.pt`` (tensors only, no arbitrary objects) onto
    `device`."""
    tree = torch.load(_path(directory, name), map_location="cpu",
                      weights_only=True)
    return to_device(tree, device)
