"""Rank grid and placement descriptors.

Counterpart of ``video_spike_tpu/parallel/mesh.py``. A JAX mesh arranges
devices on named axes and XLA inserts the collectives; here each rank of
the default process group is one process with one device, :func:`make_mesh`
arranges the ranks on a (data, model) grid in row-major order (rank =
data index × n_model + model index, as ``np.reshape(devices, (n_data,
n_model))``), and the trainers issue the collectives themselves over each
axis's process group.

Axes:

- ``data``: batch sharding; each rank on one data row holds its own rows
  of the global batch and a replica of the parameters;
- ``model``: tensor sharding. A ``Placement`` names the dimension it
  splits (``dim``: ``P(None, None, "model")`` is dim 2, or -1), block j
  on the ranks with model index j:
  the rows of the wide Linear first Dense when served
  (``models/linear.first_layer_sharding_rules``); the VTT's stacked
  session heads and biases on the neuron axis and its wide 2-D kernels by
  columns (``models/vtt.vtt_sharding_rules``, the production rules) when
  trained by the tensor-sharded step or served. The trainers keep their
  parameters replicated under a model axis, as the JAX package's do: the
  ranks of a data row then hold the same rows of the batch.

With no process group the mesh is the one-rank grid {data: 1, model: 1}
and every group is None: the trainers' collectives are then no-ops.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch.distributed as dist


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class Mesh:
    """A (data, model) grid of ranks: ``shape`` maps each axis to its size,
    ``coords`` this rank's index on each axis, ``groups`` each axis's
    process group (None for an axis of size 1)."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]] = field(repr=False)

    def group(self, axis: str):
        return self.groups[axis]


def _axis_group(all_ranks: Sequence[Sequence[int]], mine: Sequence[int],
                world: int):
    """The process group of this rank's line along an axis. Every rank
    creates every line's group, in the same order (``new_group`` is
    collective); a line spanning the world is the default group."""
    if len(mine) == 1:
        return None
    if len(mine) == world:
        return dist.group.WORLD
    group = None
    for ranks in all_ranks:
        g = dist.new_group(list(ranks))
        if list(ranks) == list(mine):
            group = g
    return group


def grid_shape(n_data: Optional[int] = None, n_model: int = 1) -> tuple:
    """(n_data, n_model) of :func:`make_mesh`'s grid over the default
    process group, creating no group; raises as ``make_mesh`` does when
    the grid does not cover the ranks."""
    _, world = _world()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {{data: {n_data}, model: {n_model}}} does "
                         f"not cover the {world} ranks of the process group")
    return n_data, n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """Arrange the ranks of the default process group on (data, model)."""
    rank, world = _world()
    n_data, n_model = grid_shape(n_data, n_model)
    grid = np.arange(world).reshape(n_data, n_model)
    d, m = divmod(rank, n_model)
    groups = {
        "data": _axis_group(grid.T.tolist(), grid[:, m].tolist(), world),
        "model": _axis_group(grid.tolist(), grid[d].tolist(), world)}
    return Mesh({"data": n_data, "model": n_model},
                {"data": d, "model": m}, groups)


@dataclass(frozen=True)
class Placement:
    """Where a tensor lives on the mesh: ``axis`` None is replicated on
    every rank; ``axis="data"`` (or ``"model"``) splits dimension ``dim``
    (negative counts from the end) in contiguous blocks, block i on the
    ranks with index i on that axis."""
    mesh: Mesh
    axis: Optional[str] = None
    ndim: int = 1
    dim: int = 0

    def split_dim(self, ndim: int) -> int:
        """``dim`` as a non-negative index into a tensor of `ndim` dims."""
        return self.dim % ndim

    @property
    def parts(self) -> int:
        """The number of blocks (1 when replicated)."""
        return 1 if self.axis is None else self.mesh.shape[self.axis]


def batch_sharding(mesh: Mesh, ndim: int = 1) -> Placement:
    """Leading (batch) axis split over ``data``; the rest whole."""
    return Placement(mesh, "data", ndim)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def pad_batch_to_multiple(batch: Dict, multiple: int,
                          array_keys: Optional[Sequence[str]] = None):
    """Pad the leading axis of every array in `batch` so it divides the mesh
    ``data`` axis; returns (padded_batch, n_valid). Padding repeats the last
    element; downstream eval trims with n_valid."""
    sizes = [v.shape[0] for v in batch.values() if isinstance(v, np.ndarray)]
    if not sizes:
        return batch, 0
    n = sizes[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch, n
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and (array_keys is None or k in array_keys):
            reps = np.repeat(v[-1:], pad, axis=0)
            out[k] = np.concatenate([v, reps], axis=0)
        else:
            out[k] = v
    return out, n
