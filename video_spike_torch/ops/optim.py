"""Optimizers, the one-cycle schedule and stochastic rounding into bf16.

Counterpart of ``video_spike_tpu/ops/optim.py`` (``_hash_bits``,
``_sr_to_bf16``, ``apply_updates_sr``) and of the optax transforms that
``video_spike_tpu/train/base.py:make_optimizer`` builds for this slice:
``optax.adafactor`` (optax 0.2.6, ``_src/factorized.py``), ``optax.adamw``
and ``optax.cosine_onecycle_schedule``, ported value for value.

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


# ---------------------------------------------------------------------------
# optax.adafactor (param_scale=False, clipping=None, no momentum / decay)
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
    """``optax.adafactor(lr, multiply_by_parameter_scale=False,
    clipping_threshold=None)``: factored second-moment scaling, then ``lr``,
    then ``-1``.

    As in optax, every statistic is stored in the param's dtype (bf16 for a
    bf16 leaf) and the factored axes are the two largest, wherever they sit.
    The state mirrors optax's ``FactoredState``: ``count`` plus per-leaf
    ``v_row``, ``v_col`` (factored) and ``v`` (unfactored) with (1,)-shaped
    placeholders."""

    def __init__(self, learning_rate, decay_rate: float = 0.8,
                 eps: float = 1e-30, min_dim_size_to_factor: int = 128):
        self.lr = learning_rate
        self.decay_rate = decay_rate
        self.eps = eps
        self.min_dim = min_dim_size_to_factor

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
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]):
        count = int(state["count"])
        decay = _f32(np.float32(1.0) - np.float32(count + 1)
                     ** np.float32(-self.decay_rate))
        keep = _f32(np.float32(1.0) - np.float32(decay))
        lr = _lr_at(self.lr, count)
        updates, v_row, v_col, v = {}, {}, {}, {}
        for k, g in grads.items():
            dtype = params[k].dtype
            g_sq = g * g + self.eps
            dims = factored_dims(tuple(g.shape), self.min_dim)
            if dims is not None:
                d1, d0 = dims
                # jnp.mean of a bf16 array sums in f32 and rounds the mean
                mean_r = g_sq.float().mean(dim=d0).to(g.dtype).float()
                mean_c = g_sq.float().mean(dim=d1).to(g.dtype).float()
                new_r = (decay * state["v_row"][k].float()
                         + keep * mean_r).to(dtype)
                new_c = (decay * state["v_col"][k].float()
                         + keep * mean_c).to(dtype)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                rc_mean = new_r.float().mean(dim=reduced_d1,
                                             keepdim=True).to(dtype)
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
            lr_t = torch.tensor(lr, dtype=g.dtype, device=g.device)
            updates[k] = -(lr_t * u)
        return updates, {"count": count + 1, "v_row": v_row,
                         "v_col": v_col, "v": v}


# ---------------------------------------------------------------------------
# optax.adamw
# ---------------------------------------------------------------------------

class AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay)``: Adam moments in the
    param dtype, bias correction, decoupled weight decay added to the
    update, then ``-lr``. State: ``count``, ``mu``, ``nu``."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads: Mapping[str, torch.Tensor], state: dict,
               params: Mapping[str, torch.Tensor]):
        count = int(state["count"])
        c = count + 1
        bc1 = _f32(np.float32(1.0) - np.float32(self.b1) ** np.float32(c))
        bc2 = _f32(np.float32(1.0) - np.float32(self.b2) ** np.float32(c))
        lr = _lr_at(self.lr, count)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1 - self.b2) * (g * g) + self.b2 * state["nu"][k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            u = u + self.weight_decay * params[k]
            updates[k] = -lr * u
        return updates, {"count": c, "mu": mu, "nu": nu}


# ---------------------------------------------------------------------------
# make_optimizer (train/base.py:50-135, the names this slice ports)
# ---------------------------------------------------------------------------

_NOT_PORTED = ("is not ported yet; see ROADMAP.md Queue A item 4 "
               "(optimizer names and trainer paths this slice leaves out)")


def make_optimizer(config, total_steps: int):
    """(optimizer, schedule) for ``config.optimizer``: AdamW (the yaml
    default) or lean adafactor, with the OneCycle cosine schedule of the JAX
    trainer. Options outside this slice raise ``NotImplementedError``."""
    opt = config.optimizer
    accum = int(opt.get("gradient_accumulation_steps", 1) or 1)
    if accum > 1:
        raise NotImplementedError(f"gradient_accumulation_steps={accum} "
                                  + _NOT_PORTED)
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
    if name == "adafactor":
        lean = (opt.get("param_scale", True) is False
                and opt.get("clipping", 1.0) is None
                and opt.get("momentum") is None
                and opt.get("adafactor_wd") is None)
        if not lean:
            raise NotImplementedError(
                "adafactor with param_scale, clipping, momentum or "
                "adafactor_wd " + _NOT_PORTED
                + "; set param_scale: false, clipping: null")
        return Adafactor(schedule), schedule
    if name != "adamw":
        raise NotImplementedError(f"optimizer.name={name!r} " + _NOT_PORTED)
    if opt.get("param_dtype") == "bfloat16_sr":
        raise NotImplementedError(
            "adamw with param_dtype=bfloat16_sr (adamw_sr_bf16) "
            + _NOT_PORTED)
    if opt.get("lowmem_state"):
        raise NotImplementedError("adamw_lowmem " + _NOT_PORTED)
    if opt.get("mu_dtype"):
        raise NotImplementedError("adamw mu_dtype " + _NOT_PORTED)
    return AdamW(schedule, weight_decay=opt.get("wd", 0.01),
                 eps=opt.get("eps", 1e-8)), schedule
