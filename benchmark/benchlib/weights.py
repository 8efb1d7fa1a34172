"""A cell's starting parameters, made by the benchmark from the seed by
the configuration's stated init, and loaded into the program before its
first step, so that the reference starts from weights the program did not
make.

The reference module lists the leaves (``param_specs``: name -> shape,
init, fan-in) and the dtype each is stored in (``store_dtype``). The
random leaves are drawn on the device from one generator, as one stream
of uniforms in chunks of ``CHUNK`` elements, each mapped through the
inverse normal CDF of its init:

- ``lecun``: flax's ``lecun_normal``, variance 1 / fan-in, a normal
  truncated at two standard deviations (its standard deviation corrected
  by ``TRUNC_STD`` for the cut);
- ``normal``: a normal of standard deviation ``fan`` (0.02 for the tokens);
- ``zeros`` and ``ones``: constants.

A leaf stored in bfloat16 is rounded to nearest from the f32 draw."""

from __future__ import annotations

import math

import torch

MASK63 = (1 << 63) - 1
CHUNK = 1 << 25
TRUNC_STD = 0.87962566103423978      # std of a unit normal cut at +-2
_LO = 0.5 * math.erfc(2.0 / math.sqrt(2.0))   # Phi(-2)
_HI = 1.0 - _LO


def weight_seed(seed: int) -> int:
    """The weights' stream: a 64-bit LCG step away from the data's seeds."""
    return (seed * 6364136223846793005 + 1442695040888963407) & MASK63


def _inverse(u: torch.Tensor, init: str, fan: float) -> torch.Tensor:
    if init == "lecun":
        p = _LO + u * (_HI - _LO)
        std = math.sqrt(1.0 / fan) / TRUNC_STD
    else:                                    # "normal", std = fan
        p = u.clamp(1e-7, 1.0 - 1e-7)
        std = fan
    return torch.erfinv(2.0 * p - 1.0) * (math.sqrt(2.0) * std)


def make(specs: dict, store, seed: int, device: torch.device) -> dict:
    """``{name: tensor}`` on ``device``, each in ``store(name, shape)``'s
    dtype, drawn from ``seed`` as the module docstring says."""
    g = torch.Generator(device=device).manual_seed(weight_seed(seed))
    out, drawn = {}, []
    for name, (shape, init, fan) in specs.items():
        dt = store(name, shape)
        if init == "zeros":
            out[name] = torch.zeros(shape, dtype=dt, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, dtype=dt, device=device)
        elif init in ("lecun", "normal"):
            out[name] = torch.empty(shape, dtype=dt, device=device)
            drawn.append((out[name].view(-1), init, fan))
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    total = sum(v.numel() for v, _, _ in drawn)
    leaf, off = 0, 0
    for s in range(0, total, CHUNK):
        u = torch.rand(min(CHUNK, total - s), generator=g, device=device)
        used = 0
        while used < u.numel():
            v, init, fan = drawn[leaf]
            n = min(v.numel() - off, u.numel() - used)
            v[off:off + n] = _inverse(u[used:used + n], init, fan)
            used, off = used + n, off + n
            if off == v.numel():
                leaf, off = leaf + 1, 0
        del u
    return out


def load(program: dict, made: dict) -> dict:
    """Copy ``made`` into the program's parameters in place and return it
    on the host (the reference's start). The program must hold exactly the
    leaves the reference lists, in the shapes and dtypes the configuration
    states."""
    if set(program) != set(made):
        raise RuntimeError(
            f"the program's leaves differ from the reference's: only in "
            f"the program {sorted(set(program) - set(made))}, only in the "
            f"reference {sorted(set(made) - set(program))}")
    host = {}
    with torch.no_grad():
        for k, v in made.items():
            p = program[k]
            if p.shape != v.shape or p.dtype != v.dtype:
                raise RuntimeError(
                    f"{k}: the program holds {tuple(p.shape)} {p.dtype}, "
                    f"the configuration states {tuple(v.shape)} {v.dtype}")
            p.copy_(v)
            host[k] = v.to("cpu", copy=True)
    return host
