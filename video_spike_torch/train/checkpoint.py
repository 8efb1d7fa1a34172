"""Checkpoint save/load (counterpart of ``video_spike_tpu/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file of plain containers (dicts, lists,
tuples, ints, floats and CPU tensors), written to a temporary file beside
the target and renamed over it, so a kill at any point leaves either the old
or the new complete checkpoint. Artifact names keep the reference's
``model_best`` / ``model_last`` contract with a ``.pt`` suffix.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch


def _path(directory: str | Path, name: str) -> Path:
    return Path(directory) / f"{name}.pt"


def to_cpu(tree: Any) -> Any:
    """Copy every tensor in a nested dict/list/tuple to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def to_device(tree: Any, device) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def save_checkpoint(directory: str | Path, name: str, tree: Any) -> str:
    """Write `tree` (tensors may live on any device) to ``directory/name.pt``
    atomically: temporary file, fsync, rename."""
    path = _path(directory, name)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            torch.save(to_cpu(tree), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return str(path)


def checkpoint_exists(directory: str | Path, name: str) -> bool:
    return _path(directory, name).is_file()


def load_checkpoint(directory: str | Path, name: str, device="cpu") -> Any:
    """Read ``directory/name.pt`` (tensors only, no arbitrary objects) onto
    `device`."""
    tree = torch.load(_path(directory, name), map_location="cpu",
                      weights_only=True)
    return to_device(tree, device)
