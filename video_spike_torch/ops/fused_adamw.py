"""AdamW over every leaf in one launch, in place.

``step_(tx, params, grads, state)`` is ``tx.update(grads, state, params)``
followed by ``apply_updates`` (``ops/optim.py``), done in place: each
parameter, the moments ``state["mu"]`` and ``state["nu"]`` and
``state["count"]`` are updated, and the dicts keep their tensors.
``AdamW.step_`` calls it.

- CUDA tensors: the hand-written kernel ``csrc/fused_adamw.cu``, one launch
  a step for up to ``MAX_LEAVES`` leaves, bitwise what the per-leaf loop
  computes on the card (its note gives the arithmetic). It takes f32,
  contiguous leaves on one card and an AdamW without ``mu_dtype``, and
  raises on anything else: there is no fallback. Each launch adds one to
  ``step_.launches``.
- CPU tensors: the plain version, the per-leaf loop itself, then ``copy_``
  into p, mu and nu.

The kernel reads its parameter and moment pointers and its work from a
device table (``_Tables``): the leaves' elements cut into chunks of
``CHUNK``, each listed as (leaf, start, length) segments by ``segments``,
and a counter from which its blocks claim the chunks. p, mu and nu are
updated in place, so their storage stays put: the table is built once and
again only when one of them moved (their ``data_ptr``s, read each step).
The gradients are new tensors every step; their pointers go to the kernel
in its parameter space, so a step copies nothing to the card and never
waits for it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Mapping

import numpy as np
import torch

_SOURCE = "fused_adamw.cu"
# csrc/fused_adamw.cu: kMaxLeaves gradient pointers in the parameter space,
# kChunk elements a chunk
MAX_LEAVES = 1024
CHUNK = 2048


@dataclasses.dataclass
class _Tables:
    """The kernel's device table, what it was built from, and the claims
    its counter holds."""
    keys: tuple           # leaf names, in the table's order
    ptrs: tuple           # p, mu, nu data_ptr of every leaf
    shapes: tuple
    device: int
    table: torch.Tensor   # int64 on the card, laid out as Args::table
    n_segs: int
    n_chunks: int
    grid: int
    claims: int = 0


def segments(numels, n_chunks: int) -> tuple:
    """(segs, first): ``segs`` an (S, 3) int64 array of (leaf, start,
    length) rows, chunk c made of rows ``first[c]:first[c + 1]``. The
    leaves' elements, each leaf padded to a multiple of 4, are concatenated
    and cut into ``n_chunks`` equal chunks, so every segment starts at a
    multiple of 4 elements of its leaf (16-byte aligned where the leaf is)
    and only a leaf's last segment may end off a multiple of 4."""
    numels = np.asarray(numels, dtype=np.int64).reshape(-1)
    groups = -(-numels // 4)
    start = np.concatenate([[0], np.cumsum(groups)])
    per = max(1, -(-int(start[-1]) // n_chunks))
    live = np.flatnonzero(groups)
    c0 = start[live] // per
    counts = (start[live + 1] - 1) // per - c0 + 1
    leaf = np.repeat(live, counts)
    chunk = np.repeat(c0 - np.cumsum(counts) + counts, counts) \
        + np.arange(int(counts.sum()))
    g0 = np.maximum(start[leaf], chunk * per)
    g1 = np.minimum(start[leaf + 1], (chunk + 1) * per)
    seg_start = 4 * (g0 - start[leaf])
    seg_len = np.minimum(4 * (g1 - start[leaf]), numels[leaf]) - seg_start
    first = np.searchsorted(chunk, np.arange(n_chunks + 1))
    return np.stack([leaf, seg_start, seg_len], axis=1), first


def _library() -> ctypes.CDLL:
    from video_spike_torch.ops import cuda_lib

    lib = cuda_lib.load(_SOURCE)
    fn = lib.vst_fused_adamw_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.POINTER(ctypes.c_uint64),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.vst_fused_adamw_blocks_per_sm
        occ.argtypes = [ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _max_grid(index: int) -> int:
    """Resident blocks on card ``index``: blocks an SM times SMs."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _library().vst_fused_adamw_blocks_per_sm(ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"fused AdamW: occupancy query failed "
                           f"(cudaError {err}, {blocks.value} blocks)")
    props = torch.cuda.get_device_properties(index)
    return blocks.value * props.multi_processor_count


def _leaf_problems(name: str, t: torch.Tensor, what: str, shape,
                   index: int) -> list:
    out = []
    if t.dtype != torch.float32:
        out.append(f"{what} {name} is {t.dtype} (f32 only)")
    if not t.is_cuda or t.get_device() != index:
        out.append(f"{what} {name} on {t.device}, the first parameter on "
                   f"cuda:{index}")
    if not t.is_contiguous():
        out.append(f"{what} {name} is not contiguous")
    if t.shape != shape:
        out.append(f"{what} {name} has shape {tuple(t.shape)}, its "
                   f"parameter {tuple(shape)}")
    return out


def _build(params, mu, nu, keys: tuple, ptrs: tuple, index: int) -> _Tables:
    problems = []
    for k in keys:
        shape = params[k].shape
        for what, t in (("parameter", params[k]), ("mu", mu[k]),
                        ("nu", nu[k])):
            problems += _leaf_problems(k, t, what, shape, index)
    if problems:
        raise ValueError("fused AdamW: " + "; ".join(problems))
    numels = [params[k].numel() for k in keys]
    n_chunks = max(1, -(-sum(-(-n // 4) for n in numels) // (CHUNK // 4)))
    segs, first = segments(numels, n_chunks)
    flat = np.concatenate([np.asarray(ptrs, dtype=np.int64),
                           segs.reshape(-1), first, [0]])
    table = torch.from_numpy(flat).to(f"cuda:{index}")
    return _Tables(keys, ptrs, tuple(params[k].shape for k in keys), index,
                   table, len(segs), n_chunks,
                   min(_max_grid(index), n_chunks))


def _launch(tx, params: Mapping[str, torch.Tensor],
            grads: Mapping[str, torch.Tensor], state: dict,
            count: int) -> None:
    if tx.mu_dtype is not None:
        raise ValueError(f"fused AdamW: mu_dtype {tx.mu_dtype} (the kernel "
                         f"keeps f32 moments only)")
    keys = tuple(params)
    if len(keys) > MAX_LEAVES:
        raise ValueError(f"fused AdamW: {len(keys)} leaves, the kernel "
                         f"takes at most {MAX_LEAVES}")
    if grads.keys() != params.keys():
        raise ValueError(f"fused AdamW: gradients for "
                         f"{sorted(set(grads) ^ set(params))} do not match "
                         f"the parameters")
    if not keys:
        return
    mu, nu = state["mu"], state["nu"]
    ptrs = tuple(x for k in keys for x in (
        params[k].data_ptr(), mu[k].data_ptr(), nu[k].data_ptr()))
    tables = tx._fused_tables
    if tables is None or tables.keys != keys or tables.ptrs != ptrs:
        tables = _build(params, mu, nu, keys, ptrs,
                        params[keys[0]].get_device())
        tx._fused_tables = tables
    index = tables.device
    # a strided gradient (CEBRA's kernels') is read from a contiguous copy
    gptrs, copies = [], []
    for k, shape in zip(keys, tables.shapes):
        g = grads[k]
        if not g.is_contiguous():
            g = g.contiguous()
            copies.append(g)
        if (g.dtype != torch.float32 or not g.is_cuda
                or g.get_device() != index or g.shape != shape):
            raise ValueError("fused AdamW: " + "; ".join(
                _leaf_problems(k, g, "gradient", shape, index)))
        gptrs.append(g.data_ptr())
    bc1, bc2, lr = tx.corrections(count)
    one = np.float32(1.0)
    scalars = (ctypes.c_float * 9)(
        tx.b1, 1 - tx.b1, tx.b2, 1 - tx.b2, one / np.float32(bc1),
        one / np.float32(bc2), tx.eps, tx.weight_decay, -lr)
    lib = _library()
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        err = lib.vst_fused_adamw_f32(
            tables.table.data_ptr(), len(keys), tables.n_segs,
            tables.n_chunks, tables.grid, tables.claims,
            (ctypes.c_uint64 * len(keys))(*gptrs), scalars, stream)
    if err != 0:
        raise RuntimeError(f"fused AdamW kernel launch failed: cudaError "
                           f"{err} ({len(keys)} leaves, {tables.n_segs} "
                           f"segments, {tables.n_chunks} chunks, grid "
                           f"{tables.grid})")
    tables.claims += tables.n_chunks + tables.grid
    step_.launches += 1


def _plain(tx, params: Mapping[str, torch.Tensor],
           grads: Mapping[str, torch.Tensor], state: dict) -> None:
    """The per-leaf loop, then ``copy_`` into p, mu and nu: CPU only."""
    on_card = [k for d in (params, grads, state["mu"], state["nu"])
               for k, t in d.items() if t.device.type != "cpu"]
    if on_card:
        raise ValueError(f"fused AdamW: mixed devices (the first parameter "
                         f"on the CPU, {sorted(set(on_card))} not)")
    updates, new = tx.update(grads, state, params)
    for k, u in updates.items():
        p = params[k]
        p.copy_((p + u).to(p.dtype))
        state["mu"][k].copy_(new["mu"][k])
        state["nu"][k].copy_(new["nu"][k])


@torch.no_grad()
def step_(tx, params: Mapping[str, torch.Tensor],
          grads: Mapping[str, torch.Tensor], state: dict) -> None:
    """One AdamW step of ``tx`` in place (see the module's docstring)."""
    count = int(state["count"])
    first = next(iter(params.values()), None)
    if first is not None and first.is_cuda:
        _launch(tx, params, grads, state, count)
    else:
        _plain(tx, params, grads, state)
    state["count"] = count + 1


step_.launches = 0
