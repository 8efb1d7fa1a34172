"""Transformer parts shared by the ViT models: sin-cos position tables,
flax's LayerNorm, multi-head self-attention and the pre-LN block.

Counterpart of the parts of ``video_spike_tpu/models/vit_mae.py`` that the
VTT flagship uses (``_sincos_1d``, ``sincos_pos_embed_2d``,
``sincos_pos_embed_1d``, ``SelfAttention``, ``Block``). The MAE backbone and
its contrastive wrappers are not ported yet (ROADMAP.md Queue A item 10).

Precision follows flax's per-module dtypes, cast explicitly (no autocast):

- ``Dense(dtype=bf16)`` casts the f32 kernel and bias to bf16 on every call
  and returns bf16 (``ops/fused_readout.dense``); kernels keep flax's
  (in, out) layout and ``lecun_normal`` init;
- ``LayerNorm`` takes its statistics in f32 with flax's fast variance
  (E[x²] − E[x]², clipped at 0), normalises in f32 with the f32 scale and
  bias, and casts once to its dtype;
- GELU is the tanh approximation and the block's LayerNorm eps is 1e-12,
  the VTT's settings (the erf GELU and the f32 LayerNorm dtype of the
  weight-import paths come with the VideoMAE slice).

Parameter names follow the flax tree: ``Block_0.LayerNorm_0.scale``,
``Block_0.SelfAttention_0.qkv.kernel`` and so on.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from video_spike_torch.models.linear import Dense
from video_spike_torch.ops.attention import attention_bshd
from video_spike_torch.ops.fused_readout import dense


# ---------------------------------------------------------------------------
# position embeddings (numpy copies of the JAX package's tables)
# ---------------------------------------------------------------------------

def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(dim // 2, dtype=np.float64)
    omega = 1.0 / 10000 ** (omega / (dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_pos_embed_2d(dim: int, grid_size: int,
                        cls_token: bool = True) -> np.ndarray:
    grid_h = np.arange(grid_size, dtype=np.float64)
    grid_w = np.arange(grid_size, dtype=np.float64)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first (HF convention)
    grid = np.stack(grid, axis=0).reshape(2, -1)
    emb = np.concatenate(
        [_sincos_1d(dim // 2, grid[0]), _sincos_1d(dim // 2, grid[1])], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, dim)), emb], axis=0)
    return emb.astype(np.float32)


def sincos_pos_embed_1d(dim: int, length: int) -> np.ndarray:
    """1-D sinusoid table in the concatenated (sin | cos) layout."""
    return _sincos_1d(dim, np.arange(length, dtype=np.float64)).astype(
        np.float32)


class PosTable:
    """A fixed numpy position table as a tensor, copied to each device once."""

    def __init__(self, make):
        self._make = make
        self._cache: dict = {}

    def get(self, key, device: torch.device) -> torch.Tensor:
        if (key, device) not in self._cache:
            self._cache[(key, device)] = torch.from_numpy(
                self._make(key)).to(device)
        return self._cache[(key, device)]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(epsilon, dtype)`` over the last axis."""

    def __init__(self, features: int, eps: float = 1e-6,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        mean2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class SelfAttention(nn.Module):
    """qkv Dense -> ``attention_bshd`` -> proj Dense."""

    def __init__(self, hidden: int, heads: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.hidden, self.heads, self.dtype = hidden, heads, dtype
        self.qkv = Dense(hidden, 3 * hidden, device=device)
        self.proj = Dense(hidden, hidden, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.qkv.reset_parameters(generator)
        self.proj.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        qkv = dense(x, self.qkv.kernel, self.qkv.bias, self.dtype)
        qkv = qkv.reshape(b, s, 3, self.heads, self.hidden // self.heads)
        out = attention_bshd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        out = out.reshape(b, s, self.hidden)
        return dense(out, self.proj.kernel, self.proj.bias, self.dtype)


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(LN(x)), then x + MLP(LN(x)).

    The residual adds follow torch's type promotion, which is JAX's here: a
    bf16 branch added to an f32 stream stays f32."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.LayerNorm_0 = LayerNorm(hidden, 1e-12, dtype, device)
        self.SelfAttention_0 = SelfAttention(hidden, heads, dtype, device)
        self.LayerNorm_1 = LayerNorm(hidden, 1e-12, dtype, device)
        self.Dense_0 = Dense(hidden, mlp_dim, device=device)
        self.Dense_1 = Dense(mlp_dim, hidden, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.LayerNorm_0, self.SelfAttention_0, self.LayerNorm_1,
                  self.Dense_0, self.Dense_1):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.SelfAttention_0(self.LayerNorm_0(x))
        y = dense(self.LayerNorm_1(x), self.Dense_0.kernel, self.Dense_0.bias,
                  self.dtype)
        y = F.gelu(y, approximate="tanh")
        return x + dense(y, self.Dense_1.kernel, self.Dense_1.bias,
                         self.dtype)
