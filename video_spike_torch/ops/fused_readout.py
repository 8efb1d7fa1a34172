"""Fused low-rank update for the giant readout layer.

Counterpart of ``video_spike_tpu/ops/fused_readout.py``. The Linear model's
first Dense kernel is (M, N) = (1,966,080, 256), ~503M parameters. At batch
B its gradient is rank B, ``G = x^T @ dz``, so the production optimizer step
(adafactor numerics + a stochastically rounded bf16 store) runs from the
factors without ever forming G:

1. Both factored second-moment statistics have closed forms
   (``lowrank_row_col_sq``), evaluated as sums of squares after an eigh of
   a tiny (B, B) PSD matrix.
2. The scaled update is ``(x*a)^T @ (dz*c)``, and the parameter write
   ``W <- SR(W + xa^T @ dzc)`` is one hand-written CUDA kernel
   (``csrc/fused_readout.cu``) that streams W once in and once out, in
   place, for any M, N and B. Its shared-memory plan (tile, ring depth,
   B-chunk) is computed here by ``_launch_plan`` and passed to the kernel.
   Its plain torch version, ``_apply_scaled_outer_plain``, forms the f32
   (M, N) product, the index and the hash like the JAX package's XLA path;
   it runs for CPU tensors and as the kernel's reference.

The same update carries the VideoMAE probe's ``encoder_head`` kernel,
(1,204,224, 256) at batch 8, over cached frozen features
(``make_fused_probe_head_step``).

Under data parallelism (``group`` of the mesh's ``data`` axis) the step
never all-reduces the (M, N) gradient, which it does not have: each rank
all-gathers the rank-B factors (``flat`` and ``dz``, rows in rank order, so
row b of the gathered batch is row b of the global batch) and runs the same
update on the global batch with the same seed, so the replicas of W stay
bitwise equal without a broadcast. The other leaves' gradients and the loss
are all-reduced with SUM (the criterion divides by the global row count).

Parameters are a flat dict ``{"encoder.Dense_0.kernel": tensor, ...}``
whose kernels keep the flax (in, out) layout, so the SR bits, keyed by the
flat index ``row*N + col``, match the JAX package's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple

import numpy as np
import torch

from video_spike_torch.core.spans import span
from video_spike_torch.ops.dense import dense, preprocess_flat
from video_spike_torch.ops.optim import MASK32, mix_bits, seed_key
from video_spike_torch.ops.step import update
from video_spike_torch.parallel.multihost import (
    gather_rows,
    sum_grads_and_loss,
)

# distinct leaf constant so the SR stream cannot collide with
# ops/optim.apply_updates_sr's small leaf ids
_LEAF_CONST = (999983 * 0x85EBCA6B) & MASK32

_SOURCE = "fused_readout.cu"
# rows of the plain version's f32 product held at once (bounds its memory)
_PLAIN_CHUNK_ELEMS = 1 << 24


class FusedReadoutState(NamedTuple):
    """Adafactor factored second moment for one (M, N) kernel."""
    count: int             # step counter
    row: torch.Tensor      # (M,) f32 row mean-square EMA
    col: torch.Tensor      # (N,) f32 col mean-square EMA


def init_fused_state(kernel: torch.Tensor) -> FusedReadoutState:
    m, n = kernel.shape
    return FusedReadoutState(
        0, torch.zeros((m,), dtype=torch.float32, device=kernel.device),
        torch.zeros((n,), dtype=torch.float32, device=kernel.device))


def _psd_sqrt_t(k: torch.Tensor) -> torch.Tensor:
    """sqrt(Λ) Qᵀ of a tiny (B, B) PSD matrix, eigenvalues clamped >= 0."""
    lam, q = torch.linalg.eigh(k)
    return torch.sqrt(torch.clamp(lam, min=0.0))[:, None] * q.T


def lowrank_row_col_sq(x: torch.Tensor, dz: torch.Tensor):
    """(rowsum_n G², colsum_m G²) of G = xᵀ @ dz, without forming G.

    ``x``: (B, M), ``dz``: (B, N); f32 math whatever the input dtypes.
    row_sq[m] = x[:,m]ᵀ (dz dzᵀ) x[:,m] is evaluated as Σ_b ((√Λ Qᵀ) x)[b,m]²
    — a sum of squares, non-negative by construction, with relative
    rounding error (the mixed-sign form cancelled to negatives at the
    production scale; see the JAX package's docstring). The statistic does
    not depend on the sign or basis of the eigenvectors.
    """
    xf = x.float()
    dzf = dz.float()
    z = _psd_sqrt_t(dzf @ dzf.T) @ xf                # (B, M)
    row_sq = (z * z).sum(dim=0)                      # (M,)
    w = _psd_sqrt_t(xf @ xf.T) @ dzf                 # (B, N)
    col_sq = (w * w).sum(dim=0)                      # (N,)
    return row_sq, col_sq


def _mix_bits(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """The JAX package's ``_mix_bits``: murmur3 finalizer over absolute flat
    element indices (int64 holding uint32 values)."""
    return mix_bits(idx, seed_key(seed, _LEAF_CONST))


def _sr_add_to_bf16(w_bf16: torch.Tensor, upd32: torch.Tensor,
                    bits: torch.Tensor) -> torch.Tensor:
    """SR(w + upd) into bf16 (same rounding as ops/optim._sr_to_bf16)."""
    s = w_bf16.float() + upd32
    raw = s.view(torch.int32).to(torch.int64) & MASK32
    top = ((raw + (bits & 0xFFFF)) & MASK32) >> 16
    top = torch.where(top >= 0x8000, top - 0x10000, top)
    return top.to(torch.int16).view(torch.bfloat16)


def _apply_scaled_outer_plain(w: torch.Tensor, xa: torch.Tensor,
                              dzc: torch.Tensor, seed: int) -> torch.Tensor:
    """Torch transcription of ``_apply_scaled_outer_xla``: returns
    SR_bf16(f32(W) + xaᵀ @ dzc) for a bf16 W (a new tensor). Rows go in
    chunks so the f32 product and the int64 hash temporaries stay bounded;
    the bits depend only on the absolute index, so chunking changes none."""
    m, n = w.shape
    out = torch.empty_like(w)
    cols = torch.arange(n, dtype=torch.int64, device=w.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // n)
    for r0 in range(0, m, step):
        r1 = min(r0 + step, m)
        upd = xa[:, r0:r1].T @ dzc                   # (rows, N) f32
        rows = torch.arange(r0, r1, dtype=torch.int64, device=w.device)
        flat = (rows[:, None] * n + cols[None, :]) & MASK32
        out[r0:r1] = _sr_add_to_bf16(w[r0:r1], upd, _mix_bits(flat, seed))
    return out


# ---------------------------------------------------------------------------
# the CUDA kernel's launch plan (csrc/fused_readout.cu; its layout mirrors
# _smem_bytes, and the kernel refuses a plan whose bytes disagree)
# ---------------------------------------------------------------------------

_SMEM_ONE_BLOCK = 232_448    # opt-in dynamic shared memory of a block (sm_90)
_SMEM_TWO_BLOCKS = 115_712   # two blocks an SM: 2 * (bytes + 1 KB) <= 228 KB
_CONSUMERS = 256             # the kernel's consumer threads (8 warps)
_ROWS = 4                    # the rows a consumer item owns
_MAX_STAGES = 4
_W_TILE_BYTES = 16_384       # the preferred W tile (TM rows x TN columns)


class LaunchPlan(NamedTuple):
    """How the kernel lays out one launch. ``tm`` x ``tn`` is a W tile,
    ``stages`` the ring's depth, ``b_chunk`` the factor rows a ring stage
    holds (``b_chunk == B`` and ``dzc_resident``: dzc stays in shared memory
    for the block's life), ``vec`` 8-column items with 16-byte stores (N %
    8 == 0 and W 16-byte aligned) or single columns, ``w_mode`` how a W
    tile arrives (0: the producer warp's loads, 1: one bulk copy of the
    contiguous tile, 2: one bulk copy a row), ``xa_tma`` whether xa's rows
    arrive by bulk copy (M % 4 == 0, xa 16-byte aligned), ``acc_smem``
    whether a B-chunked tile keeps its sums in shared memory (more items
    than consumer threads)."""
    tm: int
    tn: int
    stages: int
    b_chunk: int
    vec: bool
    w_mode: int
    xa_tma: bool
    dzc_resident: bool
    acc_smem: bool
    smem_bytes: int
    blocks_per_sm: int


def _align(x: int, a: int = 128) -> int:
    return (x + a - 1) // a * a


def _items(tm: int, tn: int, vec: bool) -> int:
    """Consumer items of a tile, padded to whole warps: an item is _ROWS
    rows x 8 columns (vec) or x 1 column, and a warp takes 4 row groups x 8
    column groups (vec) or one row group x 32 columns."""
    if vec:
        return (tm // _ROWS) * (-(-(tn // 8) // 8) * 8)
    return (tm // _ROWS) * (-(-tn // 32) * 32)


def _smem_bytes(tm, tn, stages, b_chunk, b, n, vec, dzc_resident,
                acc_smem) -> int:
    """Bytes of the kernel's dynamic shared memory: the ring's barriers,
    the resident dzc (B x N f32), the B-chunked sums, then ``stages``
    stages of [W tile (tm x tn bf16) | xa (b_chunk x tm f32) | dzc chunk
    (b_chunk x tn f32, when not resident)], each part 128-byte aligned."""
    stage = (_align(tm * tn * 2) + _align(b_chunk * tm * 4)
             + (0 if dzc_resident else _align(b_chunk * tn * 4)))
    acc = (_align(_items(tm, tn, vec) * _ROWS * (8 if vec else 1) * 4)
           if acc_smem else 0)
    return (_align(16 * stages) + (_align(b * n * 4) if dzc_resident else 0)
            + acc + stages * stage)


@functools.lru_cache(maxsize=256)
def _launch_plan(m: int, n: int, b: int, *, w_aligned: bool = True,
                 xa_aligned: bool = True) -> LaunchPlan:
    """The launch plan for W (m, n), xa (b, m), dzc (b, n): every shape gets
    one. Candidates are scored, best first, by: dzc resident; the widest
    column tile; consumer threads with work on an SM; W bytes in flight on
    an SM (the ring less the stage being computed); the tallest tile."""
    vec = n % 8 == 0 and w_aligned
    tm_step = 4 * _ROWS if vec else 8
    col_step = 64 if vec else 32
    xa_tma = m % 4 == 0 and xa_aligned
    tns = [n] + [t for t in (4096, 2048, 1024, 512, 256, 128, 64, 32)
                 if t < n and t % col_step == 0]
    best, best_key = None, None
    for tn in tns:
        # the preferred W tile, or the rows that give every consumer an item
        fill = -(-_CONSUMERS * tm_step // _items(tm_step, tn, vec))
        tm_top = max(_W_TILE_BYTES // (2 * tn), fill)
        tm_top = max(tm_step, min(256, -(-m // tm_step) * tm_step,
                                  tm_top // tm_step * tm_step))
        for tm in range(tm_top, 0, -tm_step):
            items = _items(tm, tn, vec)
            for bps, cap in ((2, _SMEM_TWO_BLOCKS), (1, _SMEM_ONE_BLOCK)):
                for resident in (True, False):
                    acc_smem = not resident and items > _CONSUMERS

                    def size(stages, bc):
                        return _smem_bytes(tm, tn, stages, bc, b, n, vec,
                                           resident, acc_smem)

                    if resident:
                        bc = b
                    else:   # the most factor rows that fit a 2-stage ring
                        lo, hi = 0, b
                        while lo < hi:
                            mid = (lo + hi + 1) // 2
                            lo, hi = (mid, hi) if size(2, mid) <= cap \
                                else (lo, mid - 1)
                        bc = lo if lo <= 8 else lo - lo % 8
                    if bc == 0 or size(2, bc) > cap:
                        continue
                    stages = 2
                    while stages < _MAX_STAGES and size(stages + 1, bc) <= cap:
                        stages += 1
                    key = (resident, tn, bps * min(items, _CONSUMERS),
                           bps * (stages - 1) * tm * tn * 2, tm)
                    if best_key is None or key > best_key:
                        if vec:
                            w_mode = 1 if tn == n else 2
                        else:
                            w_mode = 1 if tn == n and w_aligned else 0
                        best_key = key
                        best = LaunchPlan(tm, tn, stages, bc, vec, w_mode,
                                          xa_tma, resident, acc_smem,
                                          size(stages, bc), bps)
    return best


class _CPlan(ctypes.Structure):
    """``VstPlan`` of csrc/fused_readout.cu."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "tm", "tn", "stages", "b_chunk", "vec", "w_mode", "xa_tma",
        "dzc_resident", "acc_smem", "smem_bytes", "grid")]


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_cuda(w: torch.Tensor, xa: torch.Tensor, dzc: torch.Tensor,
                 seed: int) -> None:
    m, n = w.shape
    b = xa.shape[0]
    dev = w.device
    problems = []
    if w.dtype != torch.bfloat16:
        problems.append(f"W dtype {w.dtype} (bf16 only)")
    if xa.dtype != torch.float32 or dzc.dtype != torch.float32:
        problems.append(f"xa/dzc dtypes {xa.dtype}/{dzc.dtype} (f32 only)")
    if xa.device != dev or dzc.device != dev:
        problems.append(f"devices W {dev}, xa {xa.device}, dzc {dzc.device}")
    if xa.shape != (b, m) or dzc.shape != (b, n):
        problems.append(f"shapes W {tuple(w.shape)}, xa {tuple(xa.shape)}, "
                        f"dzc {tuple(dzc.shape)} (want (B, M), (B, N))")
    if not (w.is_contiguous() and xa.is_contiguous()
            and dzc.is_contiguous()):
        problems.append("non-contiguous input")
    if m == 0 or b == 0 or n == 0:
        problems.append(f"M={m}, N={n}, B={b} (need M, N, B > 0)")
    if problems:
        raise ValueError("apply_scaled_outer kernel: " + "; ".join(problems))
    plan = _launch_plan(m, n, b, w_aligned=w.data_ptr() % 16 == 0,
                        xa_aligned=xa.data_ptr() % 16 == 0)
    tiles = -(-m // plan.tm) * -(-n // plan.tn)
    grid = min(tiles, plan.blocks_per_sm * _sm_count(dev.index))
    c_plan = _CPlan(plan.tm, plan.tn, plan.stages, plan.b_chunk,
                    int(plan.vec), plan.w_mode, int(plan.xa_tma),
                    int(plan.dzc_resident), int(plan.acc_smem),
                    plan.smem_bytes, grid)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vst_apply_scaled_outer_bf16(
            w.data_ptr(), xa.data_ptr(), dzc.data_ptr(), m, n, b,
            int(seed) & MASK32, ctypes.byref(c_plan), stream)
    if err != 0:
        raise RuntimeError(f"apply_scaled_outer kernel launch failed: "
                           f"cudaError {err} ({plan})")
    apply_scaled_outer.launches += 1


def _library() -> ctypes.CDLL:
    from video_spike_torch.ops import cuda_lib

    lib = cuda_lib.load(_SOURCE)
    fn = lib.vst_apply_scaled_outer_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_uint32, ctypes.POINTER(_CPlan),
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def apply_scaled_outer(w: torch.Tensor, xa: torch.Tensor, dzc: torch.Tensor,
                       seed: int) -> torch.Tensor:
    """W += xaᵀ @ dzc in place, stochastically rounded for a bf16 W; returns W.

    - bf16 W on a CUDA device: the hand-written kernel (or an error; there
      is no fallback). Each launch adds one to ``apply_scaled_outer.launches``.
    - bf16 W on the CPU: the plain torch version.
    - f32 (or other) W: the plain f32 add, as the XLA path does (the kernel
      contract is bf16 only; this is not SR and not a fallback).
    """
    if w.dtype != torch.bfloat16:
        w.copy_((w.float() + xa.T @ dzc).to(w.dtype))
        return w
    if w.device.type == "cuda":
        _launch_cuda(w, xa, dzc, seed)
        return w
    if w.device.type != "cpu":
        raise ValueError(f"apply_scaled_outer: unsupported device {w.device}")
    w.copy_(_apply_scaled_outer_plain(w, xa, dzc, seed))
    return w


apply_scaled_outer.launches = 0


def fused_readout_update(kernel: torch.Tensor, x: torch.Tensor,
                         dz: torch.Tensor, state: FusedReadoutState, lr,
                         *, decay_rate: float = 0.8, eps: float = 1e-30,
                         seed: int):
    """One adafactor step on ``kernel`` from the rank-B grad factors; the
    kernel is updated IN PLACE. Returns ``(kernel, new_state)``.

    Matches optax adafactor (decay ``1 - t^-0.8``, factored rsqrt scaling,
    ``-lr`` step) followed by ``apply_updates_sr``'s f32 add + stochastic
    rounding for a bf16 kernel, with the gradient kept in exact f32 factored
    form. ``lr`` is a scalar or a schedule called with the pre-increment
    count.
    """
    count = state.count + 1
    beta = np.float32(1.0) - np.float32(count) ** np.float32(-decay_rate)
    one_minus_beta = float(np.float32(1.0) - beta)
    beta = float(beta)
    lr_t = float(lr(state.count)) if callable(lr) else float(lr)
    m, n = kernel.shape

    row_sq, col_sq = lowrank_row_col_sq(x, dz)
    # defense in depth vs roundoff-negative statistics (a no-op for the
    # sum-of-squares form, load-bearing for any other)
    row_sq = torch.clamp(row_sq, min=0.0)
    col_sq = torch.clamp(col_sq, min=0.0)
    r = beta * state.row + one_minus_beta * (row_sq / n + eps)
    c = beta * state.col + one_minus_beta * (col_sq / m + eps)

    # bound the per-row amplification: 1e-12 caps a at 1e6x
    a = torch.rsqrt(torch.clamp(r / r.mean(), min=1e-12))   # (M,)
    b = torch.rsqrt(c) * (-lr_t)                            # (N,)
    xa = x.float() * a[None, :]                             # (B, M)
    dzc = dz.float() * b[None, :]                           # (B, N)
    apply_scaled_outer(kernel, xa.contiguous(), dzc.contiguous(), seed)
    return kernel, FusedReadoutState(count, r, c)


# ---------------------------------------------------------------------------
# LinearModel integration: forward split at the first (giant) Dense
# ---------------------------------------------------------------------------

FIRST_KERNEL = "encoder.Dense_0.kernel"
FIRST_BIAS = "encoder.Dense_0.bias"


def tail_apply(model, params: Mapping[str, torch.Tensor],
               z1: torch.Tensor) -> torch.Tensor:
    """Everything after ``z1 = flat @ W1 + b1`` (the pre-ReLU first-Dense
    output), layer for layer as ``LinearModel.forward``. ``params`` may or
    may not hold the first kernel; only later layers are read."""
    cd = model.compute_dtype
    b = z1.shape[0]
    h = torch.relu(z1)
    n_enc = len(model.encoder_hidden)
    for idx in range(1, n_enc):
        h = torch.relu(dense(h, params[f"encoder.Dense_{idx}.kernel"],
                             params[f"encoder.Dense_{idx}.bias"], cd))
    h = dense(h, params[f"encoder.Dense_{n_enc}.kernel"],
              params[f"encoder.Dense_{n_enc}.bias"], cd)   # no relu
    n_dec = len(model.decoder_hidden)
    for idx in range(n_dec):
        h = torch.relu(dense(h, params[f"decoder.Dense_{idx}.kernel"],
                             params[f"decoder.Dense_{idx}.bias"], cd))
    h = dense(h, params[f"decoder.Dense_{n_dec}.kernel"],
              params[f"decoder.Dense_{n_dec}.bias"], cd)
    return h.float().reshape(b, model.t_bins, model.output_dim // model.t_bins)


def split_first_kernel(params: Mapping[str, torch.Tensor]):
    """(first kernel, params without it); the bias stays in the rest (its
    gradient flows through dz)."""
    rest = {k: v for k, v in params.items() if k != FIRST_KERNEL}
    return params[FIRST_KERNEL], rest


def merge_first_kernel(rest: Mapping[str, torch.Tensor],
                       kernel: torch.Tensor) -> dict:
    return {**rest, FIRST_KERNEL: kernel}


def _make_fused_step(kernel_name: str, bias_name: str, flatten, tail,
                     trains, tx_rest, schedule, criterion,
                     apply_updates_rest, group):
    """``step(params, opt_state, inputs, ap, n_valid, seed)``: the kernel
    ``kernel_name`` takes the rank-B update in place (its call in the
    ``optimizer`` span), the rest's leaves that ``trains`` accepts
    ``tx_rest``. ``flatten(inputs)`` gives the (B, M) rows the kernel
    reads, ``tail(leaves, z1)`` the outputs from ``z1 = flat @ W + b``; dz
    comes from autograd on ``z_nob``, as ``jax.value_and_grad(argnums=(0,
    1))`` gives it. With a data ``group``, ``inputs`` and ``ap`` are this
    rank's rows and ``n_valid`` the global count."""

    def step(params, opt_state, inputs, ap, n_valid, seed):
        fstate, rest_state = opt_state
        kernel = params[kernel_name]
        rest = {k: v for k, v in params.items() if k != kernel_name}
        with span("forward"):
            with torch.no_grad():
                flat = flatten(inputs)
                z_nob = flat @ kernel.to(flat.dtype)            # (B, N)
            z_nob.requires_grad_(True)
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in rest.items() if trains(k)}
            z1 = z_nob + leaves[bias_name].to(z_nob.dtype)
            loss = criterion(tail(leaves, z1), ap, n_valid)
        names = list(leaves)
        with span("backward"):
            grads = torch.autograd.grad(
                loss, [leaves[k] for k in names] + [z_nob])
        with torch.no_grad():
            g_rest, dz = dict(zip(names, grads[:-1])), grads[-1]
            loss = loss.detach()
            if group is not None:
                with span("grad_allreduce"):
                    g_rest, loss = sum_grads_and_loss(g_rest, loss, group)
                    flat, dz = gather_rows(flat, group), gather_rows(dz, group)
            with span("optimizer"):
                rest, rest_state = update(tx_rest, rest, g_rest, rest_state,
                                          apply_updates_rest, seed)
                kernel, fstate = fused_readout_update(
                    kernel, flat, dz, fstate, schedule, seed=seed)
        return {**rest, kernel_name: kernel}, (fstate, rest_state), loss

    return step


def make_fused_linear_step(model, tx_rest, schedule, criterion,
                           apply_updates_rest, group=None):
    """The Linear model's step with the first-Dense update fused (rank-B
    factors, no materialized gradient) and every other leaf on ``tx_rest``;
    ``opt_state`` is ``(FusedReadoutState, tx_rest state)``
    (:func:`init_fused_opt_state`). See :func:`_make_fused_step`."""
    return _make_fused_step(
        FIRST_KERNEL, FIRST_BIAS, lambda x: preprocess_flat(model, x),
        lambda leaves, z1: tail_apply(model, leaves, z1), lambda k: True,
        tx_rest, schedule, criterion, apply_updates_rest, group)


def init_fused_opt_state(params: Mapping[str, torch.Tensor], tx_rest,
                         split=split_first_kernel):
    kernel, rest = split(params)
    return init_fused_state(kernel), tx_rest.init(rest)


# ---------------------------------------------------------------------------
# VideoMAEProbe head integration: the frozen-feature readout
# ---------------------------------------------------------------------------
#
# The probe's trainable readout is Linear(L*D -> enc_out) -> Linear(-> 100*N)
# with no activation between (models/videomae.py head_apply). At the
# production shape the first kernel is (1,204,224, 256), ~308M parameters,
# fed from cached frozen features: the same rank-B update as the Linear
# model's first Dense, at M = 1,204,224, N = 256, B = 8.

HEAD_KERNEL = "encoder_head.kernel"
HEAD_BIAS = "encoder_head.bias"


def split_head_kernel(params: Mapping[str, torch.Tensor]):
    """(encoder_head kernel, params without it) for VideoMAEProbe."""
    rest = {k: v for k, v in params.items() if k != HEAD_KERNEL}
    return params[HEAD_KERNEL], rest


def make_fused_probe_head_step(model, tx_rest, schedule, criterion,
                               apply_updates_rest, group=None):
    """The probe's head-only step over cached frozen features (``inputs``
    the (B, L, D) backbone output), as ``VideoMAEProbe.head`` in f32: the
    encoder_head kernel takes the rank-B update, its bias and the decoder
    head ``tx_rest``; the frozen backbone comes back as it is. See
    :func:`_make_fused_step`."""
    out_dim = model.config["decoder"]["output_dim"]

    def tail(leaves, z1):
        return dense(z1, leaves["decoder_head.kernel"],
                     leaves["decoder_head.bias"], torch.float32).reshape(
                         z1.shape[0], 100, out_dim // 100)

    return _make_fused_step(
        HEAD_KERNEL, HEAD_BIAS,
        lambda hidden: hidden.reshape(hidden.shape[0], -1).float(), tail,
        lambda k: k.startswith(("encoder_head.", "decoder_head.")),
        tx_rest, schedule, criterion, apply_updates_rest, group)
