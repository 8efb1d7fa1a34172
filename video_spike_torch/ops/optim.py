"""Optimizers, the one-cycle schedule and stochastic rounding into bf16.

Counterpart of ``video_spike_tpu/ops/optim.py`` (``_hash_bits``,
``_sr_to_bf16``, ``apply_updates_sr``, ``adafactor_lean``,
``scale_by_adam_lowmem`` with ``adamw_lowmem`` / ``adamw_sr_bf16``) and of
every optax transform that ``video_spike_tpu/train/base.py:make_optimizer``
builds: ``optax.adafactor`` with each of its options (optax 0.2.6,
``_src/alias.py:225-327``), ``optax.adamw`` with ``mu_dtype``,
``optax.MultiSteps`` and ``optax.cosine_onecycle_schedule``, ported value
for value.

Every optimizer has ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)``; states are plain dicts of tensors and ints
(so ``torch.load(..., weights_only=True)`` reads a checkpoint of them).

Parameters, gradients and optimizer statistics are flat dicts
``{"encoder.Dense_0.kernel": tensor, ...}``. Where order matters (the SR leaf
ids) it is JAX's flatten order of the flax tree: sorted keys at every level,
which is the order of the names split on ``.``.

torch's uint32 support is thin, so the counter hash runs on int64 tensors
holding values in [0, 2^32), masked after every step; multiplications by
32-bit constants are split into 16-bit halves so no product reaches 2^63.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from video_spike_torch.core.logging import logging as make_logger
from video_spike_torch.ops import fused_adamw

MASK32 = 0xFFFFFFFF

Tree = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# uint32 counter hash and stochastic rounding (plain torch ops)
# ---------------------------------------------------------------------------

def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 `x` in [0, 2^32) and a 32-bit constant."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def seed_key(seed: int, leaf_const: int) -> int:
    """seed * 0x9E3779B9 + leaf_const, mod 2^32 (host integers)."""
    return (int(seed) * 0x9E3779B9 + leaf_const) & MASK32


def mix_bits(flat: torch.Tensor, key: int) -> torch.Tensor:
    """murmur3 finalizer of (flat + key) mod 2^32; int64 in, int64 out."""
    x = (flat + key) & MASK32
    x = x ^ (x >> 16)
    x = mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _hash_bits(seed: int, leaf_id: int, n: int,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """n uniform uint32 values (as int64) from the counter hash keyed by
    (seed, leaf_id); the same stream as the JAX package's ``_hash_bits``."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return mix_bits(idx, seed_key(seed, (leaf_id * 0x85EBCA6B) & MASK32))


def _sr_to_bf16(x32: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Stochastically round f32 to bf16: add the low 16 bits of `bits` to the
    f32 pattern and keep the top 16 (unbiased; the carry may bump the
    exponent; sign-magnitude makes it right for negatives too)."""
    raw = x32.contiguous().view(torch.int32).to(torch.int64) & MASK32
    top = ((raw + (bits & 0xFFFF)) & MASK32) >> 16
    top = torch.where(top >= 0x8000, top - 0x10000, top)
    return top.to(torch.int16).view(torch.bfloat16)


def jax_order(names) -> list:
    """Names in JAX's flatten order of the corresponding nested dict."""
    return sorted(names, key=lambda k: tuple(k.split(".")))


def apply_updates_sr(params: Mapping[str, torch.Tensor],
                     updates: Mapping[str, Optional[torch.Tensor]],
                     seed: int) -> Tree:
    """``optax.apply_updates`` with stochastic rounding into bf16 leaves.

    The sum is taken in f32; bf16 leaves are stochastically rounded back,
    other dtypes take the ordinary add. Leaf ids 1, 2, ... go to the bf16
    leaves only, in JAX's flatten order, as in the JAX package."""
    out = {}
    leaf_id = 0
    for name in jax_order(params):
        p, u = params[name], updates.get(name)
        if u is None:
            out[name] = p
            continue
        s = p.float() + u.float()
        if p.dtype != torch.bfloat16:
            out[name] = s.to(p.dtype)
            continue
        leaf_id += 1
        bits = _hash_bits(seed, leaf_id, p.numel(), p.device)
        out[name] = _sr_to_bf16(s, bits.reshape(p.shape))
    return out


def apply_updates(params: Mapping[str, torch.Tensor],
                  updates: Mapping[str, Optional[torch.Tensor]],
                  seed: int = 0) -> Tree:
    """``optax.apply_updates``: ``(p + u)`` cast back to the param dtype."""
    del seed
    return {k: (p if updates.get(k) is None
                else (p + updates[k]).to(p.dtype))
            for k, p in params.items()}


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3,
                             div_factor: float = 25.0,
                             final_div_factor: float = 1e4
                             ) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule``: a piecewise cosine interpolation
    from peak/div up to peak over ``pct_start`` of the steps, then down to
    peak/(div*final_div). Evaluated in float32, as optax does under JAX's
    default 32-bit mode; returns a Python float."""
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a "
                         "non-positive `transition_steps`")
    bounds = np.array([0, int(pct_start * transition_steps),
                       int(transition_steps)])
    values = np.cumprod(np.array(
        [peak_value / div_factor, div_factor,
         1.0 / (div_factor * final_div_factor)]))
    sizes = (bounds[1:] - bounds[:-1]).astype(np.float32)
    # optax forms (start - end) / 2 in float64 numpy before it meets the
    # float32 cosine; everything after that is float32
    half = ((values[:-1] - values[1:]) / 2.0).astype(np.float32)
    ends = values[1:].astype(np.float32)
    last = np.float32(values[-1])

    def schedule(count: int) -> float:
        count = int(count)
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (np.float32(count) - bounds[:-1].astype(np.float32)) / sizes
            interp = ends + half * (np.cos(np.float32(np.pi) * pct)
                                    + np.float32(1.0))
        indicator = ((bounds[:-1] <= count)
                     & (count < bounds[1:])).astype(np.float32)
        val = np.float32(np.dot(indicator, interp.astype(np.float32)))
        return float(val + np.float32(bounds[-1] <= count) * last)

    return schedule


def _lr_at(lr, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


def _f32(x) -> float:
    return float(np.float32(x))


def _weak(c: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX's weak typing meets an array of ``dtype``:
    rounded to that dtype first (bf16(0.9) is 0.8984375), so ``_weak(c,
    t.dtype) * t`` is ``c * t`` under JAX's promotion rules."""
    return c if dtype == torch.float32 else float(torch.tensor(c, dtype=dtype))


def _mean_as(x: torch.Tensor, dtype: torch.dtype, **kw) -> torch.Tensor:
    """``jnp.mean``: summed in f32, the mean rounded to ``dtype``."""
    return x.float().mean(**kw).to(dtype)


# ---------------------------------------------------------------------------
# optax.adafactor
# ---------------------------------------------------------------------------

def _pow_neg_half(x: torch.Tensor) -> torch.Tensor:
    """``x ** -0.5`` in f32, rounded to x's dtype (torch's bf16 ``rsqrt``
    rounds differently from XLA's)."""
    return x.float().pow(-0.5).to(x.dtype)


def factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax ``_factored_dims``: the two largest axes, or None when fewer
    than two axes are >= ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor:
    """``optax.adafactor(lr, multiply_by_parameter_scale,
    clipping_threshold, momentum, weight_decay_rate)``, optax's chain in its
    order: factored second-moment scaling, block-RMS clipping (when
    ``clipping_threshold`` is set), ``lr``, the parameter's block RMS
    (``multiply_by_parameter_scale``, floored at 1e-3), an f32 EMA of the
    updates (``momentum``, not debiased), ``+ weight_decay_rate * p``, then
    ``-1``. The defaults here are the lean setting (no parameter scale, no
    clipping), which the fused readout step pairs with.

    As in optax, every statistic is stored in the param's dtype (bf16 for a
    bf16 leaf) and the factored axes are the two largest, wherever they sit.
    The state mirrors optax's ``FactoredState``: ``count`` plus per-leaf
    ``v_row``, ``v_col`` (factored) and ``v`` (unfactored) with (1,)-shaped
    placeholders; with ``momentum`` also ``momentum: {count, ema}``
    (optax's ``EmaState``, f32 accumulators)."""

    def __init__(self, learning_rate, decay_rate: float = 0.8,
                 eps: float = 1e-30, min_dim_size_to_factor: int = 128,
                 multiply_by_parameter_scale: bool = False,
                 clipping_threshold: Optional[float] = None,
                 momentum: Optional[float] = None,
                 weight_decay_rate: Optional[float] = None):
        self.lr = learning_rate
        self.decay_rate = decay_rate
        self.eps = eps
        self.min_dim = min_dim_size_to_factor
        self.param_scale = bool(multiply_by_parameter_scale)
        self.clipping = clipping_threshold
        self.momentum = momentum
        self.weight_decay = weight_decay_rate

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            kw = dict(dtype=p.dtype, device=p.device)
            dims = factored_dims(tuple(p.shape), self.min_dim)
            if dims is not None:
                d1, d0 = dims
                v_row[k] = torch.zeros(np.delete(p.shape, d0).tolist(), **kw)
                v_col[k] = torch.zeros(np.delete(p.shape, d1).tolist(), **kw)
                v[k] = torch.zeros((1,), **kw)
            else:
                v_row[k] = torch.zeros((1,), **kw)
                v_col[k] = torch.zeros((1,), **kw)
                v[k] = torch.zeros(p.shape, **kw)
        state = {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}
        if self.momentum is not None:
            state["momentum"] = {"count": 0, "ema": {
                k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}}
        return state

    def _chain_tail(self, k: str, u: torch.Tensor, lr: float,
                    p: torch.Tensor, state: dict, ema: dict) -> torch.Tensor:
        """Every link after the factored scaling, for one leaf."""
        if self.clipping is not None:
            rms = torch.sqrt(_mean_as(u * u, u.dtype)) / self.clipping
            u = u / torch.maximum(torch.ones_like(rms), rms)
        u = _weak(lr, u.dtype) * u
        if self.param_scale:
            rms = torch.sqrt(_mean_as(p * p, p.dtype))
            u = u * torch.where(rms <= 1e-3,
                                torch.full_like(rms, 1e-3), rms)
        if self.momentum is not None:
            new = (_weak(1 - self.momentum, u.dtype) * u
                   + self.momentum * state["momentum"]["ema"][k])
            ema[k] = new.float()
            u = new
        if self.weight_decay is not None:
            u = u + _weak(self.weight_decay, p.dtype) * p
        return -1 * u

    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]):
        count = int(state["count"])
        decay = _f32(np.float32(1.0) - np.float32(count + 1)
                     ** np.float32(-self.decay_rate))
        keep = _f32(np.float32(1.0) - np.float32(decay))
        lr = _lr_at(self.lr, count)
        updates, v_row, v_col, v, ema = {}, {}, {}, {}, {}
        for k, g in grads.items():
            dtype = params[k].dtype
            g_sq = g * g + self.eps
            dims = factored_dims(tuple(g.shape), self.min_dim)
            if dims is not None:
                d1, d0 = dims
                mean_r = _mean_as(g_sq, g.dtype, dim=d0).float()
                mean_c = _mean_as(g_sq, g.dtype, dim=d1).float()
                new_r = (decay * state["v_row"][k].float()
                         + keep * mean_r).to(dtype)
                new_c = (decay * state["v_col"][k].float()
                         + keep * mean_c).to(dtype)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                rc_mean = _mean_as(new_r, dtype, dim=reduced_d1,
                                   keepdim=True)
                row_factor = _pow_neg_half(new_r / rc_mean)
                col_factor = _pow_neg_half(new_c)
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                v_row[k], v_col[k] = new_r, new_c
                v[k] = state["v"][k]
            else:
                new_v = (decay * state["v"][k].float()
                         + keep * g_sq.float()).to(dtype)
                u = g * _pow_neg_half(new_v)
                v_row[k], v_col[k] = state["v_row"][k], state["v_col"][k]
                v[k] = new_v
            updates[k] = self._chain_tail(k, u, lr, params[k], state, ema)
        new_state = {"count": count + 1, "v_row": v_row, "v_col": v_col,
                     "v": v}
        if self.momentum is not None:
            new_state["momentum"] = {
                "count": int(state["momentum"]["count"]) + 1, "ema": ema}
        return updates, new_state


# ---------------------------------------------------------------------------
# optax.adamw
# ---------------------------------------------------------------------------

class AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay, mu_dtype)``: Adam
    moments in the param dtype, bias correction, decoupled weight decay
    added to the update, then ``-lr``. State: ``count``, ``mu``, ``nu``.

    With ``mu_dtype`` (optax's ``scale_by_adam``) the first moment is
    stored in that dtype: the step reads it back, forms the new moment in
    the promoted dtype, uses that for the update and only then casts it
    for storage."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 mu_dtype: Optional[torch.dtype] = None):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype
        self._fused_tables = None    # ops/fused_adamw.py's device table
        self._fused_out = None       # and its out-of-place tables

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p, dtype=self.mu_dtype)
                       for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def corrections(self, count: int) -> tuple:
        """(bc1, bc2, lr) of the step from ``count``: both bias corrections
        formed in f32, as optax forms them, and the learning rate at
        ``count``; Python floats."""
        c = np.float32(count + 1)
        bc1 = _f32(np.float32(1.0) - np.float32(self.b1) ** c)
        bc2 = _f32(np.float32(1.0) - np.float32(self.b2) ** c)
        return bc1, bc2, _lr_at(self.lr, count)

    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]):
        count = int(state["count"])
        c = count + 1
        bc1, bc2, lr = self.corrections(count)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            mu_k, nu_k, p = state["mu"][k], state["nu"][k], params[k]
            m = (_weak(1 - self.b1, g.dtype) * g
                 + _weak(self.b1, mu_k.dtype) * mu_k)
            nu[k] = (_weak(1 - self.b2, g.dtype) * (g * g)
                     + _weak(self.b2, nu_k.dtype) * nu_k)
            u = (m / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            u = u + _weak(self.weight_decay, p.dtype) * p
            updates[k] = -lr * u
            mu[k] = m if self.mu_dtype is None else m.to(self.mu_dtype)
        return updates, {"count": c, "mu": mu, "nu": nu}

    def step_(self, params: Mapping[str, torch.Tensor],
              grads: Mapping[str, torch.Tensor], state: dict) -> None:
        """``update`` then ``apply_updates``, in place: the parameters,
        ``state``'s moments (the same tensors, each in its leaf's shape)
        and its count. CUDA leaves take one launch of the multi-tensor
        kernel, CPU leaves the per-leaf loop (``ops/fused_adamw.py``)."""
        fused_adamw.step_(self, params, grads, state)

    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor], state: dict) -> tuple:
        """``update`` then ``apply_updates`` into new tensors: ``(params,
        state)``, new dicts, writing nothing it was handed. CUDA leaves
        take one launch of the multi-tensor kernel into new storage, CPU
        leaves the per-leaf loop (``ops/fused_adamw.py``)."""
        return fused_adamw.step(self, params, grads, state)


# ---------------------------------------------------------------------------
# the JAX package's own transforms (video_spike_tpu/ops/optim.py)
# ---------------------------------------------------------------------------

class AdamWLowmem:
    """``adamw_lowmem`` and ``adamw_sr_bf16`` (one chain under two names):
    ``scale_by_adam_lowmem`` (Adam in f32 math, both moments stored in
    bf16, the step cast to the gradient's dtype), ``+ weight_decay * p``,
    then ``-lr`` in the update's dtype. Pair the bf16-store variant with
    :func:`apply_updates_sr`. State: ``count``, ``mu``, ``nu``."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p, dtype=torch.bfloat16)
                       for k, p in params.items()},
                "nu": {k: torch.zeros_like(p, dtype=torch.bfloat16)
                       for k, p in params.items()}}

    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]):
        count = int(state["count"])
        c = np.float32(count + 1)
        c1 = _f32(np.float32(1.0) - np.float32(self.b1) ** c)
        c2 = _f32(np.float32(1.0) - np.float32(self.b2) ** c)
        lr = _lr_at(self.lr, count)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            g32 = g.float()
            m32 = self.b1 * state["mu"][k].float() + (1 - self.b1) * g32
            v32 = (self.b2 * state["nu"][k].float()
                   + (1 - self.b2) * g32 * g32)
            step = ((m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)).to(g.dtype)
            step = step + _weak(self.weight_decay, params[k].dtype) * params[k]
            updates[k] = _weak(-lr, step.dtype) * step
            mu[k], nu[k] = m32.to(torch.bfloat16), v32.to(torch.bfloat16)
        return updates, {"count": count + 1, "mu": mu, "nu": nu}


def _lean_factored(p: torch.Tensor, min_dim: int) -> bool:
    return p.ndim == 2 and min(p.shape) >= min_dim


class AdafactorLean:
    """``adafactor_lean``: the JAX package's factored RMS without side
    passes. A 2-D leaf with both dims >= ``min_factor_dim`` keeps f32 row
    (M,) and column (N,) mean squares of ``g*g + eps``; any other leaf a
    full bf16 ``v`` in ``row`` beside a 0-d f32 placeholder in ``col``. The
    decay is ``1 - t^-0.8``, the learning rate is the schedule at the count
    before the increment, the step ``-lr * g * rsqrt(r / mean(r)) *
    rsqrt(c)`` (f32 math, no clamp) is emitted in the gradient's dtype.
    State: ``count``, ``row``, ``col`` (``FactoredRMSState``)."""

    def __init__(self, learning_rate, decay_rate: float = 0.8,
                 eps: float = 1e-30, min_factor_dim: int = 128):
        self.lr = learning_rate
        self.decay_rate = decay_rate
        self.eps = eps
        self.min_dim = min_factor_dim

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        row, col = {}, {}
        for k, p in params.items():
            kw = dict(dtype=torch.float32, device=p.device)
            if _lean_factored(p, self.min_dim):
                row[k] = torch.zeros((p.shape[0],), **kw)
                col[k] = torch.zeros((p.shape[1],), **kw)
            else:
                row[k] = torch.zeros_like(p, dtype=torch.bfloat16)
                col[k] = torch.zeros((), **kw)
        return {"count": 0, "row": row, "col": col}

    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Optional[Mapping[str, torch.Tensor]] = None):
        count = int(state["count"])
        beta = np.float32(1.0) - np.float32(count + 1) ** np.float32(
            -self.decay_rate)
        keep = float(np.float32(1.0) - beta)
        beta = float(beta)
        neg_lr = -_lr_at(self.lr, count)
        updates, row, col = {}, {}, {}
        for k, g in grads.items():
            r, c = state["row"][k], state["col"][k]
            g32 = g.float()
            g2 = g32 * g32 + self.eps
            if r.ndim == 1 and g.ndim == 2:
                r = beta * r + keep * g2.mean(dim=1)
                c = beta * c + keep * g2.mean(dim=0)
                denom = (torch.rsqrt(r / r.mean())[:, None]
                         * torch.rsqrt(c)[None, :])
                updates[k] = (neg_lr * g32 * denom).to(g.dtype)
            else:
                v32 = beta * r.float() + keep * g2
                updates[k] = (neg_lr * g32 * torch.rsqrt(v32)).to(g.dtype)
                r = v32.to(torch.bfloat16)
            row[k], col[k] = r, c
        return updates, {"count": count + 1, "row": row, "col": col}


# ---------------------------------------------------------------------------
# frozen paths and gradient accumulation
# ---------------------------------------------------------------------------

def is_frozen(name: str, frozen_paths) -> bool:
    """A leaf is frozen when any part of its dotted name is a frozen path
    (the JAX package's label rule over the flax tree's keys)."""
    return any(part in frozen_paths for part in name.split("."))


class Frozen:
    """``optax.multi_transform({"train": inner, "freeze": set_to_zero()})``
    over a flat dict: frozen leaves get no update (so no weight decay) and
    no state; the rest go to ``inner``. Updates come back for the trained
    leaves only, so ``apply_updates`` / ``apply_updates_sr`` leave the
    frozen ones untouched, where optax adds a zero update (the same values:
    SR of ``w + 0`` for a bf16 ``w`` rounds back to ``w``)."""

    def __init__(self, inner, frozen_paths):
        self.inner = inner
        self.frozen_paths = frozenset(frozen_paths)

    def trainable(self, tree: Mapping) -> dict:
        return {k: v for k, v in tree.items()
                if not is_frozen(k, self.frozen_paths)}

    def init(self, params: Mapping[str, torch.Tensor]):
        return self.inner.init(self.trainable(params))

    def update(self, grads, state, params):
        return self.inner.update(self.trainable(grads), state,
                                 self.trainable(params))


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)``: the gradients of k
    micro-steps are averaged (``acc + (g - acc) / (n + 1)``) and the k-th
    passes their mean to ``inner``; the other micro-steps emit zero updates
    and leave the inner state, and so its count and schedule, as they were.
    As in optax the inner update is formed on every micro-step and kept on
    the k-th only, and ``acc_grads`` (zeros like the params at init, a
    frozen leaf's staying zero) takes the update's dtype after each step.
    State: ``mini_step``, ``gradient_step``, ``inner``, ``acc_grads``,
    ``skip_state`` (empty: no skip function)."""

    def __init__(self, inner, every_k: int):
        self.inner = inner
        self.every_k = int(every_k)

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        return {"mini_step": 0, "gradient_step": 0,
                "inner": self.inner.init(params),
                "acc_grads": {k: torch.zeros_like(p)
                              for k, p in params.items()},
                "skip_state": ()}

    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]):
        n = int(state["mini_step"])
        emit = n == self.every_k - 1
        acc = dict(state["acc_grads"])
        for k, g in grads.items():
            acc[k] = acc[k] + (g - acc[k]) / (n + 1)
        final, inner = self.inner.update({k: acc[k] for k in grads},
                                         state["inner"], params)
        for k, u in final.items():
            acc[k] = torch.zeros_like(u) if emit else acc[k].to(u.dtype)
        if not emit:
            final = {k: u * 0 for k, u in final.items()}
            inner = state["inner"]
        return final, {"mini_step": (n + 1) % self.every_k,
                       "gradient_step": int(state["gradient_step"]) + emit,
                       "inner": inner, "acc_grads": acc, "skip_state": ()}


# ---------------------------------------------------------------------------
# make_optimizer (video_spike_tpu/train/base.py:50-135)
# ---------------------------------------------------------------------------

def make_optimizer(config, total_steps: int, frozen_paths: tuple = ()):
    """(optimizer, schedule) for ``config.optimizer``, in the JAX trainer's
    branch order: ``name: adafactor_lean``; ``name: adafactor`` (optax's
    options ``param_scale``, ``clipping``, ``momentum``, ``adafactor_wd``);
    ``param_dtype: bfloat16_sr`` (``adamw_sr_bf16``); ``lowmem_state``
    (``adamw_lowmem``); otherwise AdamW with ``mu_dtype``, whatever the
    name. The schedule is the OneCycle cosine over ``total_steps /
    gradient_accumulation_steps`` real steps. ``frozen_paths`` (names of
    parameter subtrees, the torch ``requires_grad=False`` analog) wraps the
    optimizer in :class:`Frozen`, and ``gradient_accumulation_steps > 1``
    wraps that in :class:`MultiSteps`."""
    opt = config.optimizer
    accum = int(opt.get("gradient_accumulation_steps", 1) or 1)
    # a handful of steps makes the warmup interval round to zero length
    # inside the piecewise interpolation -> nan lr; floor at 16
    schedule = cosine_onecycle_schedule(
        transition_steps=max(total_steps // accum, 16),
        peak_value=opt.lr,
        pct_start=opt.get("warmup_pct", 0.15),
        div_factor=opt.get("div_factor", 10),
        final_div_factor=1e4,
    )
    name = opt.get("name", "adamw")
    wd, eps = opt.get("wd", 0.01), opt.get("eps", 1e-8)
    if name == "adafactor_lean":
        tx = AdafactorLean(schedule)
    elif name == "adafactor":
        tx = Adafactor(
            schedule, momentum=opt.get("momentum"),
            weight_decay_rate=opt.get("adafactor_wd"),
            multiply_by_parameter_scale=opt.get("param_scale", True),
            clipping_threshold=opt.get("clipping", 1.0))
    elif opt.get("param_dtype") == "bfloat16_sr":
        tx = AdamWLowmem(schedule, weight_decay=wd, eps=eps)   # adamw_sr_bf16
    elif opt.get("lowmem_state"):
        tx = AdamWLowmem(schedule, weight_decay=wd, eps=eps)   # adamw_lowmem
    else:
        if name != "adamw":
            make_logger(header="[optim]").info(
                f"optimizer.name={name!r} is not one of adamw, adafactor, "
                f"adafactor_lean: training with AdamW, as the JAX trainer "
                f"does")
        tx = AdamW(schedule, weight_decay=wd, eps=eps,
                   mu_dtype=(torch.bfloat16
                             if opt.get("mu_dtype") == "bfloat16" else None))
    if frozen_paths:
        tx = Frozen(tx, frozen_paths)
    if accum > 1:
        tx = MultiSteps(tx, accum)
    return tx, schedule
