"""Multi-process helpers for the trainers.

Counterpart of ``video_spike_tpu/parallel/multihost.py``. There every
process runs one program over a global mesh and XLA inserts the
collectives; here every rank is one process with one device and the
collectives are explicit ``torch.distributed`` calls over the default
process group (NCCL between cards, gloo on the CPU or for ranks that share
a card). Each helper is a no-op when no process group is initialised, so
the trainers carry one code path plus thin multi-process branches.

Every collective must be called at the same program point on every rank of
its group.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from video_spike_torch.parallel.mesh import grid_shape


def is_multihost() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def process_index() -> int:
    return dist.get_rank() if is_multihost() else 0


def process_count() -> int:
    return dist.get_world_size() if is_multihost() else 1


def world_group():
    """The default group spanning every rank (None single-process): what
    the replicas of a (data, model) mesh compare over."""
    return dist.group.WORLD if is_multihost() else None


def _group_size(group) -> int:
    if group is None or not is_multihost():
        return 1
    return dist.get_world_size(group)


def _scalar_device(group=None) -> torch.device:
    """Where a collective's small host-side value travels: NCCL takes only
    CUDA tensors, gloo takes CPU ones."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Every rank waits here for the others (rank 0's checkpoint is on disk
    before any rank reads it)."""
    if is_multihost():
        dist.barrier()


def shard_files_for_process(files: Sequence[str], n_model: int = 1,
                            n_data: Optional[int] = None) -> list:
    """This rank's training shard: the ranks of data row d of
    ``make_mesh(n_data, n_model)``'s grid (d = rank // `n_model`) take
    files[d::n_data]; at ``n_model`` 1 that is files[rank::world], the
    per-rank DataLoader split of the reference's DDP sampler. Raises as
    ``make_mesh`` does for a grid that does not cover the ranks.

    The JAX package takes files[process_index::process_count]: there a data
    block's devices sit in one process (the pod layout, model within a
    host), so the process is the data row. Here every rank is one process
    with one device, so the ranks of a data row are ``n_model`` processes,
    and they must read the same rows (a model-axis replica of a block holds
    the block's rows)."""
    if not is_multihost():
        return list(files)
    n_data, n_model = grid_shape(n_data, n_model)
    return list(files)[process_index() // n_model::n_data]


def _all_reduce_int(value: int, op) -> int:
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_scalar_device())
    dist.all_reduce(t, op=op)
    return int(t.item())


def global_any(flag: bool) -> bool:
    """OR across ranks. A preemption signal lands on ranks at different
    instants; every rank must agree before any diverges into a save or out
    of a collective loop. A collective: call it at the same program point
    on every rank."""
    if not is_multihost():
        return bool(flag)
    return bool(_all_reduce_int(bool(flag), dist.ReduceOp.MAX))


def global_min(value: int) -> int:
    """Smallest value across ranks: the common step count every rank must
    agree on before entering a collective loop (local shards can differ by
    one batch)."""
    if not is_multihost():
        return int(value)
    return _all_reduce_int(value, dist.ReduceOp.MIN)


def local_rows_to_global(*arrays):
    """Distinct rank-local rows as this rank's block of the global batch
    (the train path): block i of the data-sharded batch is rank i's rows, so
    the global batch is the rank-ordered concatenation. The rows stay where
    they are; the train step's collectives read them as one batch."""
    return tuple(torch.as_tensor(np.ascontiguousarray(a))
                 if isinstance(a, np.ndarray) else a for a in arrays)


def data_axis_blocks(mesh):
    """Row-block layout of the ``data`` axis: ``(mine, g_min, private)``
    with ``mine`` this rank's block ids (one rank, one device: its data
    index), ``g_min`` the smallest block count per rank (1) and ``private``
    whether every block lives on exactly one rank (a model axis of size 1).
    The rank-local trial cache requires ``private``."""
    return [mesh.coords["data"]], 1, mesh.shape["model"] == 1


def make_block_local_take():
    """Rank-local gather: each rank takes rows of ITS OWN staged block by
    block-local indices, with no collective."""

    def take(x_blk, ap_blk, idx_blk):
        return (x_blk.index_select(0, idx_blk),
                ap_blk.index_select(0, idx_blk))

    return take


def replicated_rows_to_global(mesh, *arrays):
    """Rows identical on every rank -> this rank's block of the data-sharded
    batch (the eval path). The row count must divide the ``data`` axis
    (pad first)."""
    n_data, d = mesh.shape["data"], mesh.coords["data"]
    out = []
    for a in arrays:
        rows = a.shape[0]
        if rows % n_data:
            raise ValueError(f"{rows} rows do not divide the data axis "
                             f"{n_data}; pad them first")
        b = rows // n_data
        out.append(a[d * b:(d + 1) * b])
    return tuple(out)


def gather_dim(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Concatenate every rank's `t` along `dim`, in rank order, on every
    rank of `group`, on `t`'s device (gloo takes CUDA tensors for
    all_gather too, as NCCL does); `t` itself for a group of one."""
    if _group_size(group) == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of `t` (dim 0) in rank order: the order of the
    data-sharded global batch."""
    return gather_dim(t, 0, group)


def sum_across(tensors: Dict[str, torch.Tensor], group=None
               ) -> Dict[str, torch.Tensor]:
    """All-reduce SUM of every tensor of a dict, one collective per dtype
    over a flat buffer; returns a new dict in the same key order."""
    if _group_size(group) == 1:
        return dict(tensors)
    out = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for k, v in tensors.items():
        by_dtype.setdefault(v.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([tensors[k].reshape(-1) for k in keys])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        off = 0
        for k in keys:
            n = tensors[k].numel()
            out[k] = flat[off:off + n].view(tensors[k].shape)
            off += n
    return {k: out[k] for k in tensors}


def sum_grads_and_loss(grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                       group=None):
    """(grads, loss) summed over `group` in one collective per dtype: the
    data-parallel reduction of a step whose criterion divides by the global
    row count. A no-op for a group of one."""
    if _group_size(group) == 1:
        return grads, loss
    reduced = sum_across({**grads, "__loss__": loss.reshape(1)}, group)
    return reduced, reduced.pop("__loss__")[0]


def replica_checksums(tensors: Dict[str, torch.Tensor], group=None) -> list:
    """Each rank's 64-bit sum of the 32-bit words (bytes for an odd size)
    of every tensor, in rank order: equal entries mean equal replicas up to
    a collision. A collective over `group`."""
    total = 0
    for t in tensors.values():
        flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
        words = flat.view(torch.int32) if flat.numel() % 4 == 0 else flat
        total = (total + int(torch.sum(words, dtype=torch.int64))) % (1 << 63)
    mine = torch.tensor([total], dtype=torch.int64)
    if _group_size(group) == 1:
        return [total]
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    if dist.get_backend(group) == "nccl":
        mine = mine.to(_scalar_device(group))
        parts = [p.to(mine.device) for p in parts]
    dist.all_gather(parts, mine, group=group)
    return [int(p.item()) for p in parts]


def check_replicas(tensors: Dict[str, torch.Tensor], group=None) -> int:
    """The replicas' common checksum (:func:`replica_checksums`); raises
    when the ranks of `group` disagree (the replicas drifted apart)."""
    sums = replica_checksums(tensors, group)
    if len(set(sums)) != 1:
        raise RuntimeError(f"parameter replicas differ across ranks: "
                           f"checksums {sums}")
    return sums[0]


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce SUM of one tensor (a count, a partial product) over
    `group`; returns a new tensor (`t` itself for a group of one)."""
    if _group_size(group) == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def replicate_tree(tree):
    """Make every tensor of a (nested dict / list / tuple) tree equal to
    rank 0's, in place, by broadcast; returns the tree. Single-process it
    returns the tree as it is."""
    if not is_multihost():
        return tree
    for t in _leaves(tree):
        dist.broadcast(t, src=0)
    return tree


def _block(v: torch.Tensor, place, name: str) -> torch.Tensor:
    """This rank's contiguous block of `v` along the placement's dim."""
    dim = place.split_dim(v.ndim)
    n, j = place.parts, place.mesh.coords[place.axis]
    if v.shape[dim] % n:
        raise ValueError(f"{name}: dimension {dim} of {tuple(v.shape)} does "
                         f"not divide the {place.axis} axis {n}")
    b = v.shape[dim] // n
    return v.narrow(dim, j * b, b).contiguous()


def put_tree(tree: Dict[str, torch.Tensor], shardings: Dict[str, object]):
    """Full per-rank values -> each rank's part, by a placement per leaf
    (``parallel.mesh.Placement``): a split leaf keeps this rank's
    contiguous block of its ``dim`` on its axis, a replicated leaf stays
    whole and takes rank 0's value (broadcast), so every replica agrees.
    Raises when a split dimension does not divide its axis."""
    out, whole = {}, []
    for k, v in tree.items():
        place = shardings[k]
        if place.axis is None:
            out[k] = v
            whole.append(v)
        else:
            out[k] = _block(v, place, k)
    replicate_tree(whole)
    return out


def gather_tree(tree: Dict[str, torch.Tensor], shardings: Dict[str, object]
                ) -> Dict[str, torch.Tensor]:
    """Each rank's parts -> full values on every rank (``jax.device_get``
    of a sharded tree): a split leaf is all-gathered over its axis's group
    and its blocks concatenated along its ``dim``; a replicated leaf is
    returned as it is. A collective over every split leaf's group."""
    out = {}
    for k, v in tree.items():
        place = shardings[k]
        group = None if place.axis is None else place.mesh.group(place.axis)
        out[k] = gather_dim(v, place.split_dim(v.ndim), group)
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
