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
   place. Its plain torch version, ``_apply_scaled_outer_plain``, forms the
   f32 (M, N) product, the index and the hash like the JAX package's XLA
   path; it runs for CPU tensors and as the kernel's reference.

Parameters are a flat dict ``{"encoder.Dense_0.kernel": tensor, ...}``
whose kernels keep the flax (in, out) layout, so the SR bits, keyed by the
flat index ``row*N + col``, match the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple

import numpy as np
import torch

from video_spike_torch.ops.optim import MASK32, mix_bits, seed_key

# distinct leaf constant so the SR stream cannot collide with
# ops/optim.apply_updates_sr's small leaf ids
_LEAF_CONST = (999983 * 0x85EBCA6B) & MASK32

_SOURCE = "fused_readout.cu"
_SMEM_BYTES = 48 * 1024
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
    if m == 0 or b == 0 or n == 0 or n % 8:
        problems.append(f"M={m}, N={n}, B={b} (need M, B > 0 and N % 8 == 0)")
    if problems:
        raise ValueError("apply_scaled_outer kernel: " + "; ".join(problems))
    lib = _library()
    tile_rows = lib.vst_fused_readout_tile_rows()
    smem = 4 * b * (n + tile_rows)
    if smem > _SMEM_BYTES:
        raise ValueError(f"apply_scaled_outer kernel: B*(N+{tile_rows}) "
                         f"floats = {smem} B of shared memory > "
                         f"{_SMEM_BYTES}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vst_apply_scaled_outer_bf16(
            w.data_ptr(), xa.data_ptr(), dzc.data_ptr(), m, n, b,
            int(seed) & MASK32, stream)
    if err != 0:
        raise RuntimeError(f"apply_scaled_outer kernel launch failed: "
                           f"cudaError {err}")
    apply_scaled_outer.launches += 1


def _library() -> ctypes.CDLL:
    from video_spike_torch.ops import cuda_lib

    lib = cuda_lib.load(_SOURCE)
    fn = lib.vst_apply_scaled_outer_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_uint32, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.vst_fused_readout_tile_rows.argtypes = []
        lib.vst_fused_readout_tile_rows.restype = ctypes.c_int
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


def preprocess_flat(model, x: torch.Tensor) -> torch.Tensor:
    """The LinearModel input path before the first Dense: uint8 -> [0, 1]
    in the compute dtype, flatten."""
    b = x.shape[0]
    if x.dtype == torch.uint8:
        x = x.to(model.compute_dtype) / 255.0
    return x.reshape(b, -1).to(model.compute_dtype)


def dense(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: both operands cast to the compute dtype,
    ``h @ kernel + bias`` with the (in, out) kernel."""
    return h.to(dtype) @ kernel.to(dtype) + bias.to(dtype)


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


def make_fused_linear_step(model, tx_rest, schedule, criterion,
                           apply_updates_rest):
    """Build ``step(params, opt_state, inputs, ap, n_valid, seed)`` with the
    first-Dense update fused (rank-B factors, no materialized gradient) and
    every other leaf on ``tx_rest``. ``opt_state`` is
    ``(FusedReadoutState, tx_rest state)``; see :func:`init_fused_opt_state`.

    The first kernel is updated in place; the returned params dict holds the
    same kernel tensor and new tensors for the rest. dz comes from autograd
    on ``z_nob`` through the tail, as ``jax.value_and_grad(argnums=(0, 1))``
    gives it in the JAX package.
    """

    def step(params, opt_state, inputs, ap, n_valid, seed):
        fstate, rest_state = opt_state
        kernel, rest = split_first_kernel(params)
        with torch.no_grad():
            flat = preprocess_flat(model, inputs)
            z_nob = flat @ kernel.to(model.compute_dtype)       # (B, N)
        z_nob.requires_grad_(True)
        leaves = {k: v.detach().requires_grad_(True) for k, v in rest.items()}
        b1 = leaves[FIRST_BIAS]
        out = tail_apply(model, leaves, z_nob + b1.to(z_nob.dtype))
        loss = criterion(out, ap, n_valid)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [z_nob])
        g_rest = dict(zip(names, grads[:-1]))
        dz = grads[-1]
        with torch.no_grad():
            upd, rest_state = tx_rest.update(g_rest, rest_state, rest)
            rest = apply_updates_rest(rest, upd, seed)
            kernel, fstate = fused_readout_update(
                kernel, flat, dz, fstate, schedule, seed=seed)
        return (merge_first_kernel(rest, kernel), (fstate, rest_state),
                loss.detach())

    return step


def init_fused_opt_state(params: Mapping[str, torch.Tensor], tx_rest):
    kernel, rest = split_first_kernel(params)
    return init_fused_state(kernel), tx_rest.init(rest)
