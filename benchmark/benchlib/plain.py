"""Plain PyTorch pieces the references share, written from the published
algorithms: optax's adafactor and adamw, its one-cycle cosine schedule, the
configuration's stochastic rounding into bfloat16, and the lower precision
of the control. Nothing here imports the program."""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
LEAF_MUL = 0x85EBCA6B
FUSED_LEAF = 999983      # the fused readout kernel's leaf constant
SR_MIN_ELEMENTS = 1 << 16


@contextmanager
def exact_f32():
    """f32 matmuls and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


# -- norms by leaf, packed leaves split into the parameters they pack ------

def part_norms(name: str, t: torch.Tensor, parts: int = 1,
               chunk: int = 1 << 24) -> dict:
    """``{leaf: ||t||}``; a leaf that packs ``parts`` parameters along its
    last axis (a fused q|k|v projection) gives one norm a part, named
    ``name[i/parts]``. Large leaves are summed in chunks, in f64."""
    if parts == 1:
        flat = t.detach().reshape(-1)
        acc = torch.zeros((), dtype=torch.float64, device=flat.device)
        for s in range(0, flat.numel(), chunk):
            acc += flat[s:s + chunk].double().pow(2).sum()
        return {name: float(acc.sqrt())}
    pieces = t.detach().double().reshape(-1, parts, t.shape[-1] // parts)
    return {f"{name}[{i}/{parts}]": float(pieces[:, i].norm())
            for i in range(parts)}


# -- the lower precision of the control: fp8 (e4m3) with a per-tensor scale

def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with a per-tensor scale (its
    largest magnitude onto 448), back in f32."""
    amax = t.detach().abs().max().clamp(min=1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in f32; with both operands and the incoming gradient
    rounded to fp8 (``precision == "fp8"``, the control); or with both
    operands in bfloat16 and f32 accumulation (``"bf16"``, the precision
    the configurations compute in: a witness of what sound rounding
    reads)."""
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    if precision == "bf16":
        return (a.bfloat16() @ b.bfloat16()).float()
    return a @ b


# -- the counter hash and stochastic rounding into bfloat16 ----------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 on int64 ``x`` in [0, 2^32): the constant's two
    16-bit halves keep every product under 2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def murmur_mix(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 32-bit finalizer (int64 holding uint32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def leaf_key(seed: int, leaf_const: int) -> int:
    return (int(seed) * GOLDEN + leaf_const) & M32


def sr_bf16(s32: torch.Tensor, key: int, chunk: int = 1 << 24):
    """Stochastically round f32 ``s32`` into bfloat16: element ``i`` adds
    the low 16 bits of ``murmur_mix((i + key) mod 2^32)`` to its f32 bit
    pattern and keeps the top 16 bits. ``i`` is the flat index."""
    flat = s32.contiguous().reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.bfloat16, device=flat.device)
    for s in range(0, flat.numel(), chunk):
        part = flat[s:s + chunk]
        idx = torch.arange(s, s + part.numel(), dtype=torch.int64,
                           device=flat.device)
        bits = murmur_mix((idx + key) & M32)
        raw = part.view(torch.int32).to(torch.int64) & M32
        top = ((raw + (bits & 0xFFFF)) & M32) >> 16
        signed = top - ((top >> 15) << 16)
        out[s:s + part.numel()] = signed.to(torch.int16).view(torch.bfloat16)
    return out.reshape(s32.shape)


def store(params: dict, updates: dict, seed: int, fused=None) -> dict:
    """``p + u`` in f32 for every leaf; leaves of at least 2^16 elements
    are held in bfloat16 and stochastically rounded: the ``fused`` leaf
    with the fused readout's leaf constant, the others with leaf ids 1, 2,
    ... in the flatten order of the nested tree (names split on dots)."""
    out = {}
    leaf_id = 0
    for k in sorted(params, key=lambda n: tuple(n.split("."))):
        s = params[k] + updates[k]
        if params[k].numel() < SR_MIN_ELEMENTS:
            out[k] = s
            continue
        if k == fused:
            key = leaf_key(seed, (FUSED_LEAF * LEAF_MUL) & M32)
        else:
            leaf_id += 1
            key = leaf_key(seed, (leaf_id * LEAF_MUL) & M32)
        out[k] = sr_bf16(s, key).float()
    return out


# -- schedules and optimizers ----------------------------------------------

def onecycle(count: int, steps: int, peak: float, pct_start: float,
             div_factor: float, final_div: float = 1e4) -> float:
    """optax's ``cosine_onecycle_schedule``: cosine from peak/div up to
    peak over ``pct_start`` of the steps, then down to peak/(div*final)."""
    steps = max(int(steps), 16)
    b1 = int(pct_start * steps)
    lo, hi, end = peak / div_factor, peak, peak / (div_factor * final_div)
    if count < b1:
        start, stop, pct = lo, hi, count / b1
    elif count < steps:
        start, stop, pct = hi, end, (count - b1) / (steps - b1)
    else:
        return end
    return stop + (start - stop) / 2 * (math.cos(math.pi * pct) + 1)


class Adafactor:
    """optax ``adafactor(lr, multiply_by_parameter_scale=False,
    clipping_threshold=None)``: factored second moments over the two
    largest axes (both at least 128), decay 1 - t^-0.8, eps 1e-30, then
    ``-lr``. f32 state."""

    def __init__(self, eps: float = 1e-30, decay_rate: float = 0.8,
                 min_dim: int = 128):
        self.eps, self.decay_rate, self.min_dim = eps, decay_rate, min_dim
        self.state = {}
        self.count = 0

    def _dims(self, shape):
        if len(shape) < 2:
            return None
        order = sorted(range(len(shape)), key=lambda i: (shape[i], i))
        if shape[order[-2]] < self.min_dim:
            return None
        return order[-2], order[-1]

    def update(self, grads: dict, lr: float) -> dict:
        decay = 1.0 - (self.count + 1) ** (-self.decay_rate)
        keep = 1.0 - decay
        out = {}
        for k, g in grads.items():
            g_sq = g * g + self.eps
            dims = self._dims(tuple(g.shape))
            st = self.state.get(k)
            if dims is not None:
                d1, d0 = dims
                r = keep * g_sq.mean(dim=d0)
                c = keep * g_sq.mean(dim=d1)
                if st is not None:
                    r, c = r + decay * st[0], c + decay * st[1]
                self.state[k] = (r, c)
                rd1 = d1 - 1 if d1 > d0 else d1
                row = (r / r.mean(dim=rd1, keepdim=True)).rsqrt()
                col = c.rsqrt()
                u = g * row.unsqueeze(d0) * col.unsqueeze(d1)
            else:
                v = keep * g_sq
                if st is not None:
                    v = v + decay * st
                self.state[k] = v
                u = g * v.rsqrt()
            out[k] = -lr * u
        self.count += 1
        return out


def factored_stats(g: torch.Tensor, min_dim: int = 128) -> torch.Tensor:
    """The square roots of adafactor's first-step second-moment statistics
    of gradient ``g``, flattened: the means of g^2 over the largest axis
    and over the second largest (factored), or g^2 itself."""
    dims = Adafactor(min_dim=min_dim)._dims(tuple(g.shape))
    sq = g.double() * g.double()
    if dims is None:
        return sq.sqrt().reshape(-1).float().cpu()
    d1, d0 = dims
    return torch.cat([sq.mean(dim=d0).sqrt().reshape(-1),
                      sq.mean(dim=d1).sqrt().reshape(-1)]).float().cpu()


class AdamW:
    """optax ``adamw(lr, b1=0.9, b2=0.999, eps, weight_decay)``: bias
    corrected moments, decoupled decay on every leaf, then ``-lr``. f32."""

    def __init__(self, weight_decay: float, eps: float = 1e-8,
                 b1: float = 0.9, b2: float = 0.999):
        self.wd, self.eps, self.b1, self.b2 = weight_decay, eps, b1, b2
        self.mu, self.nu = {}, {}
        self.count = 0

    def update(self, grads: dict, params: dict, lr: float) -> dict:
        self.count += 1
        t = self.count
        out = {}
        for k, g in grads.items():
            zero = torch.zeros_like(g)
            mu = self.b1 * self.mu.get(k, zero) + (1 - self.b1) * g
            nu = self.b2 * self.nu.get(k, zero) + (1 - self.b2) * g * g
            self.mu[k], self.nu[k] = mu, nu
            mhat = mu / (1 - self.b1 ** t)
            vhat = nu / (1 - self.b2 ** t)
            out[k] = -lr * (mhat / (vhat.sqrt() + self.eps)
                            + self.wd * params[k])
        return out
