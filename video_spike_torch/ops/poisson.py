"""Poisson negative log-likelihood training losses.

Semantics of ``torch.nn.PoissonNLLLoss(log_input=True, full=False)`` as the
reference trainer uses it (``src/train.py:59``, ``src/trainer/base.py:141-143``):

    loss = exp(log_rate) - target * log_rate        (elementwise)

Counterpart of ``video_spike_tpu/ops/poisson.py``; plain torch ops.
"""

from __future__ import annotations

import math

import torch


def poisson_nll(log_rates: torch.Tensor, targets: torch.Tensor,
                log_input: bool = True, full: bool = False,
                eps: float = 1e-8) -> torch.Tensor:
    """Elementwise Poisson NLL, matching torch.nn.PoissonNLLLoss semantics."""
    if log_input:
        loss = torch.exp(log_rates) - targets * log_rates
    else:
        loss = log_rates - targets * torch.log(log_rates + eps)
    if full:
        # Stirling approximation term for target > 1 (torch convention)
        t = targets
        stirling = t * torch.log(t) - t + 0.5 * torch.log(2 * math.pi * t)
        loss = loss + torch.where(t > 1, stirling, torch.zeros_like(stirling))
    return loss


def poisson_nll_mean(log_rates: torch.Tensor, targets: torch.Tensor,
                     n_valid_rows: int | torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Mean-reduced log-input Poisson NLL — the supervised training loss.

    `n_valid_rows` masks trailing batch rows that pad a ragged batch to the
    fixed batch size (the mean is taken over valid elements only).
    """
    nll = poisson_nll(log_rates.float(), targets.float())
    if n_valid_rows is None:
        return nll.mean()
    b = log_rates.shape[0]
    valid = (torch.arange(b, device=nll.device) < n_valid_rows).to(nll.dtype)
    valid = valid.reshape((b,) + (1,) * (nll.ndim - 1))
    per_row = nll.numel() // b
    return (nll * valid).sum() / (n_valid_rows * per_row)
