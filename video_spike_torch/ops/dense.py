"""flax's Dense, which every model calls, and the Linear model's input
path, which the fused readout step shares; plain torch ops."""

from __future__ import annotations

import torch


def dense(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: both operands cast to the compute dtype,
    ``h @ kernel + bias`` with the (in, out) kernel."""
    return h.to(dtype) @ kernel.to(dtype) + bias.to(dtype)


def preprocess_flat(model, x: torch.Tensor) -> torch.Tensor:
    """The LinearModel input path before the first Dense: uint8 -> [0, 1]
    in the compute dtype, flatten."""
    b = x.shape[0]
    if x.dtype == torch.uint8:
        x = x.to(model.compute_dtype) / 255.0
    return x.reshape(b, -1).to(model.compute_dtype)
