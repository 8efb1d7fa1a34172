"""AdamW over every leaf in one launch, in place or into new tensors.

``step_(tx, params, grads, state)`` is ``tx.update(grads, state, params)``
followed by ``apply_updates`` (``ops/optim.py``), done in place: each
parameter, the moments ``state["mu"]`` and ``state["nu"]`` and
``state["count"]`` are updated, and the dicts keep their tensors.
``AdamW.step_`` calls it.

``step(tx, params, grads, state)`` is the same update into new tensors:
it returns ``(params, state)``, new dicts of new tensors and the next
count, and writes nothing it was handed, as optax's pure ``adamw`` does.
``AdamW.step`` calls it.

- CUDA tensors: the hand-written kernel ``csrc/fused_adamw.cu``, one launch
  a step for up to ``MAX_LEAVES`` leaves, bitwise what the per-leaf loop
  computes on the card (its note gives the arithmetic). It takes f32,
  contiguous leaves on one card and an AdamW without ``mu_dtype``, and
  raises on anything else: there is no fallback. Each launch adds one to
  ``step_.launches`` or ``step.launches``.
- CPU tensors: the plain version, the per-leaf loop itself (``step_`` then
  copies into p, mu and nu).

The kernel reads its work from a device table (``_Tables``): the leaves'
elements cut into chunks of ``CHUNK``, each listed as (leaf, start,
length) segments by ``segments``, and a counter from which its blocks
claim the chunks. The gradients are new tensors every step; their
pointers go to the kernel in its parameter space, so a step copies
nothing to the card and never waits for it.

- ``step_`` updates p, mu and nu in place, so their storage stays put:
  their pointers are in the table, which is built once and again only
  when one of them moved (their ``data_ptr``s, read each step).
- ``step`` writes p', mu' and nu' into three flat buffers it allocates each
  step from the caching allocator, each leaf at an offset padded to 4
  elements (so float4 still applies), and hands out views of them; it
  never reuses storage across steps, so a state a caller keeps stays as it
  was. Every pointer is new each step, so all of them (p, mu, nu, p', mu',
  nu', g: 7 a leaf, at most ``MAX_OUT_LEAVES`` leaves) go in the
  parameter space, and its table (``_Outputs.tables``) holds the work
  alone: built once for a set of leaf shapes, counted in
  ``step.tables_built``. The inputs are checked when their pointers are
  new to it (``_Outputs.checked``, the last ``CHECKED`` sets).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Mapping, Optional

import numpy as np
import torch

_SOURCE = "fused_adamw.cu"
# csrc/fused_adamw.cu: kMaxLeaves gradient pointers in the parameter space
# (kMaxOutLeaves leaves of 7 pointers out of place), kChunk elements a chunk
MAX_LEAVES = 1024
MAX_OUT_LEAVES = 576
CHUNK = 2048
# input pointer sets ``step`` keeps as checked: the first step's inputs and
# the two sets of storage that alternate after it, and one to spare
CHECKED = 4


@dataclasses.dataclass
class _Tables:
    """The kernel's device table, what it was built from, and the claims
    its counter holds."""
    keys: tuple           # leaf names, in the table's order
    ptrs: tuple           # p, mu, nu data_ptr of every leaf (None: step)
    shapes: tuple
    device: int
    table: torch.Tensor   # int64 on the card: Args::table, OutArgs::table
    n_segs: int
    n_chunks: int
    grid: int
    claims: int = 0


@dataclasses.dataclass
class _Outputs:
    """``step``'s layout of the new tensors in their flat buffers, its work
    table, and the input pointer sets it has checked."""
    keys: tuple
    shapes: tuple
    numels: list
    strides: tuple
    offsets: np.ndarray   # each leaf's first element in a buffer
    total: int            # elements a buffer
    tables: Optional[_Tables] = None
    checked: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, keys: tuple, shapes: tuple) -> "_Outputs":
        numels = [int(np.prod(s, dtype=np.int64)) for s in shapes]
        padded = [-(-n // 4) * 4 for n in numels]
        offsets = np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(
            np.int64)
        strides = tuple(tuple(int(np.prod(s[i + 1:], dtype=np.int64))
                              for i in range(len(s))) for s in shapes)
        return cls(keys, shapes, numels, strides, offsets, int(sum(padded)))

    def views(self, buf: torch.Tensor) -> dict:
        """Each leaf's tensor in ``buf``, in its shape."""
        return {k: buf.as_strided(s, st, o) for k, s, st, o in zip(
            self.keys, self.shapes, self.strides, self.offsets.tolist())}


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


def out_pointers(bases, offsets) -> np.ndarray:
    """(L, 3) int64: each leaf's p', mu' and nu' pointer, its f32
    ``offsets`` into the three buffers that start at ``bases``."""
    offsets = np.asarray(offsets, dtype=np.int64).reshape(-1, 1)
    return np.asarray(bases, dtype=np.int64).reshape(1, 3) + 4 * offsets


def _library() -> ctypes.CDLL:
    from video_spike_torch.ops import cuda_lib

    lib = cuda_lib.load(_SOURCE)
    if lib.vst_fused_adamw_f32.argtypes is None:
        for fn in (lib.vst_fused_adamw_f32, lib.vst_fused_adamw_out_f32):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_longlong,
                           ctypes.POINTER(ctypes.c_uint64),
                           ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        occ = lib.vst_fused_adamw_blocks_per_sm
        occ.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _max_grid(index: int, out: bool = False) -> int:
    """Resident blocks on card ``index`` of the in-place kernel, or of the
    out-of-place one: blocks an SM times SMs."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _library().vst_fused_adamw_blocks_per_sm(int(out),
                                                       ctypes.byref(blocks))
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


def _check(params, mu, nu, keys: tuple, index: int) -> None:
    """Raise unless p, mu and nu are what the kernel takes."""
    problems = []
    for k in keys:
        shape = params[k].shape
        for what, t in (("parameter", params[k]), ("mu", mu[k]),
                        ("nu", nu[k])):
            problems += _leaf_problems(k, t, what, shape, index)
    if problems:
        raise ValueError("fused AdamW: " + "; ".join(problems))


def _build(keys: tuple, shapes: tuple, numels: list, ptrs, index: int,
           out: bool = False) -> _Tables:
    """The table over leaves of ``numels`` elements: in place, after every
    leaf's p, mu, nu pointer (``ptrs``); out of place, the work alone."""
    n_chunks = max(1, -(-sum(-(-n // 4) for n in numels) // (CHUNK // 4)))
    segs, first = segments(numels, n_chunks)
    flat = np.concatenate([np.asarray(() if ptrs is None else ptrs,
                                      dtype=np.int64),
                           segs.reshape(-1), first, [0]])
    table = torch.from_numpy(flat).to(f"cuda:{index}")
    return _Tables(keys, ptrs, shapes, index, table, len(segs), n_chunks,
                   min(_max_grid(index, out), n_chunks))


def _keys(tx, params: Mapping[str, torch.Tensor],
          grads: Mapping[str, torch.Tensor], limit: int) -> tuple:
    if tx.mu_dtype is not None:
        raise ValueError(f"fused AdamW: mu_dtype {tx.mu_dtype} (the kernel "
                         f"keeps f32 moments only)")
    keys = tuple(params)
    if len(keys) > limit:
        raise ValueError(f"fused AdamW: {len(keys)} leaves, the kernel "
                         f"takes at most {limit}")
    if grads.keys() != params.keys():
        raise ValueError(f"fused AdamW: gradients for "
                         f"{sorted(set(grads) ^ set(params))} do not match "
                         f"the parameters")
    return keys


def _in_pointers(keys: tuple, params, mu, nu) -> tuple:
    return tuple(x for k in keys for x in (
        params[k].data_ptr(), mu[k].data_ptr(), nu[k].data_ptr()))


def _grad_pointers(tables: _Tables, grads: Mapping[str, torch.Tensor]
                   ) -> tuple:
    """(pointers, copies): each gradient's ``data_ptr`` in the table's leaf
    order; a strided gradient (CEBRA's kernels') is read from a contiguous
    copy, which the caller keeps until the launch is queued."""
    index = tables.device
    gptrs, copies = [], []
    for k, shape in zip(tables.keys, tables.shapes):
        g = grads[k]
        if not g.is_contiguous():
            g = g.contiguous()
            copies.append(g)
        if (g.dtype != torch.float32 or not g.is_cuda
                or g.get_device() != index or g.shape != shape):
            raise ValueError("fused AdamW: " + "; ".join(
                _leaf_problems(k, g, "gradient", shape, index)))
        gptrs.append(g.data_ptr())
    return gptrs, copies


def _launch(fn, tx, tables: _Tables, pointers, count: int) -> None:
    """One launch of ``fn`` over ``tables`` on the current stream, handed
    ``pointers`` (a ctypes uint64 array)."""
    bc1, bc2, lr = tx.corrections(count)
    one = np.float32(1.0)
    scalars = (ctypes.c_float * 9)(
        tx.b1, 1 - tx.b1, tx.b2, 1 - tx.b2, one / np.float32(bc1),
        one / np.float32(bc2), tx.eps, tx.weight_decay, -lr)
    index = tables.device
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        err = fn(tables.table.data_ptr(), len(tables.keys), tables.n_segs,
                 tables.n_chunks, tables.grid, tables.claims, pointers,
                 scalars, stream)
    if err != 0:
        raise RuntimeError(f"fused AdamW kernel launch failed: cudaError "
                           f"{err} ({len(tables.keys)} leaves, "
                           f"{tables.n_segs} segments, {tables.n_chunks} "
                           f"chunks, grid {tables.grid})")
    tables.claims += tables.n_chunks + tables.grid


def _launch_in_place(tx, params: Mapping[str, torch.Tensor],
                     grads: Mapping[str, torch.Tensor], state: dict,
                     count: int) -> None:
    keys = _keys(tx, params, grads, MAX_LEAVES)
    if not keys:
        return
    mu, nu = state["mu"], state["nu"]
    ptrs = _in_pointers(keys, params, mu, nu)
    tables = tx._fused_tables
    if tables is None or tables.keys != keys or tables.ptrs != ptrs:
        index = params[keys[0]].get_device()
        _check(params, mu, nu, keys, index)
        tables = _build(keys, tuple(params[k].shape for k in keys),
                        [params[k].numel() for k in keys], ptrs, index)
        tx._fused_tables = tables
    gptrs, copies = _grad_pointers(tables, grads)
    _launch(_library().vst_fused_adamw_f32, tx, tables,
            (ctypes.c_uint64 * len(keys))(*gptrs), count)
    step_.launches += 1


def _launch_out(tx, params: Mapping[str, torch.Tensor],
                grads: Mapping[str, torch.Tensor], state: dict,
                count: int) -> tuple:
    """(p', mu', nu') dicts of views into three new flat buffers."""
    keys = _keys(tx, params, grads, MAX_OUT_LEAVES)
    if not keys:
        return {}, {}, {}
    mu, nu = state["mu"], state["nu"]
    first = params[keys[0]]
    index = first.get_device()
    shapes = tuple(params[k].shape for k in keys)
    outs = tx._fused_out
    if outs is None or outs.keys != keys or outs.shapes != shapes \
            or outs.tables.device != index:
        outs = tx._fused_out = _Outputs.of(keys, shapes)
        outs.tables = _build(keys, shapes, outs.numels, None, index,
                             out=True)
        step.tables_built += 1
    in_ptrs = _in_pointers(keys, params, mu, nu)
    if in_ptrs not in outs.checked:
        _check(params, mu, nu, keys, index)
        if len(outs.checked) >= CHECKED:
            del outs.checked[next(iter(outs.checked))]
        outs.checked[in_ptrs] = True
    gptrs, copies = _grad_pointers(outs.tables, grads)
    bufs = [torch.empty(outs.total, dtype=torch.float32, device=first.device)
            for _ in range(3)]
    ptrs = np.empty((len(keys), 7), dtype=np.uint64)
    ptrs[:, :3] = np.asarray(in_ptrs, dtype=np.uint64).reshape(-1, 3)
    ptrs[:, 3:6] = out_pointers([b.data_ptr() for b in bufs], outs.offsets)
    ptrs[:, 6] = gptrs
    _launch(_library().vst_fused_adamw_out_f32, tx, outs.tables,
            ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), count)
    step.launches += 1
    return tuple(outs.views(b) for b in bufs)


def _plain(tx, params: Mapping[str, torch.Tensor],
           grads: Mapping[str, torch.Tensor], state: dict) -> tuple:
    """The per-leaf loop into new tensors: CPU only."""
    on_card = [k for d in (params, grads, state["mu"], state["nu"])
               for k, t in d.items() if t.device.type != "cpu"]
    if on_card:
        raise ValueError(f"fused AdamW: mixed devices (the first parameter "
                         f"on the CPU, {sorted(set(on_card))} not)")
    updates, new = tx.update(grads, state, params)
    return {k: (params[k] + u).to(params[k].dtype)
            for k, u in updates.items()}, new


@torch.no_grad()
def step_(tx, params: Mapping[str, torch.Tensor],
          grads: Mapping[str, torch.Tensor], state: dict) -> None:
    """One AdamW step of ``tx`` in place (see the module's docstring)."""
    count = int(state["count"])
    first = next(iter(params.values()), None)
    if first is not None and first.is_cuda:
        _launch_in_place(tx, params, grads, state, count)
    else:
        new_p, new = _plain(tx, params, grads, state)
        for k, p in new_p.items():
            params[k].copy_(p)
            state["mu"][k].copy_(new["mu"][k])
            state["nu"][k].copy_(new["nu"][k])
    state["count"] = count + 1


step_.launches = 0


@torch.no_grad()
def step(tx, params: Mapping[str, torch.Tensor],
         grads: Mapping[str, torch.Tensor], state: dict) -> tuple:
    """``(params, state)`` after one AdamW step of ``tx`` into new tensors
    (see the module's docstring)."""
    count = int(state["count"])
    first = next(iter(params.values()), None)
    if first is not None and first.is_cuda:
        new_p, mu, nu = _launch_out(tx, params, grads, state, count)
        return new_p, {"count": count + 1, "mu": mu, "nu": nu}
    return _plain(tx, params, grads, state)


step.launches = 0
step.tables_built = 0
