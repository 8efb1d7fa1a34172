"""Signal / preprocessing ops: Gaussian smoothing, standardization, one-hot.

Counterpart of ``video_spike_tpu/ops/signal.py``:

- ``gaussian_filter1d`` is ``scipy.ndimage.gaussian_filter1d(y, sigma,
  axis)`` (truncate 4) with scipy's ``reflect`` boundary, as used on spike
  counts (reference ``src/train_rrr.py:118``), in torch. scipy's ``reflect``
  repeats the edge sample (d c b a | a b c d | d c b a), which is numpy's
  ``symmetric`` pad; torch's ``F.pad(mode="reflect")`` leaves the edge
  sample out, so the pad is built from reflected indices instead;
- ``standardize`` (reference ``_std``), ``one_hot_per_trial`` (``_one_hot``)
  and ``minmax_per_trial`` are host-side numpy, run once per session during
  data prep.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    return phi / phi.sum()


def _symmetric_index(length: int, radius: int) -> torch.Tensor:
    """Source index of every sample of a `radius`-padded row under numpy's
    ``symmetric`` rule (period 2 * length, the edge sample repeated)."""
    idx = torch.arange(-radius, length + radius) % (2 * length)
    return torch.where(idx < length, idx, 2 * length - 1 - idx)


def gaussian_filter1d(arr, sigma: float, axis: int = -1,
                      truncate: float = 4.0) -> torch.Tensor:
    """Gaussian smoothing along one axis with scipy's 'reflect' boundary;
    float32 out, on the input tensor's device (the CPU for numpy input)."""
    arr = torch.as_tensor(arr).float()
    radius = int(truncate * float(sigma) + 0.5)
    kernel = torch.as_tensor(_gaussian_kernel1d(sigma, radius),
                             dtype=torch.float32, device=arr.device)

    moved = arr.movedim(axis, -1)
    lead_shape = moved.shape[:-1]
    length = moved.shape[-1]
    flat = moved.reshape(-1, length)
    padded = flat[:, _symmetric_index(length, radius).to(arr.device)]
    # the kernel is symmetric, so cross-correlation equals jnp.convolve
    out = F.conv1d(padded[:, None, :], kernel[None, None, :])[:, 0]
    return out.reshape(*lead_shape, length).movedim(-1, axis)


def standardize(arr) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Standardize over the leading axis. Returns (standardized, mean, std);
    std clipped at 1e-8 (reference `_std`)."""
    arr = np.asarray(arr)
    mean = np.mean(arr, axis=0)
    std = np.clip(np.std(arr, axis=0), 1e-8, None)
    return (arr - mean) / std, mean, std


def one_hot_per_trial(arr, T: int, categories=None) -> np.ndarray:
    """Categorical per-trial values -> (K, T, n_categories) indicators.

    `arr` is (K,) or (K, 1); unique values are sorted and each becomes a
    channel that is constant across the T timesteps (reference `_one_hot`).
    Pass `categories` to pin the channel set (e.g. the union across splits,
    so train/test encodings stay aligned when a split misses a value).
    """
    arr = np.asarray(arr).reshape(len(arr), -1)[:, 0]
    cats = np.sort(np.unique(arr)) if categories is None \
        else np.sort(np.asarray(categories))
    out = np.zeros((len(arr), T, len(cats)))
    for i, c in enumerate(cats):
        out[:, :, i] = (arr == c)[:, None]
    return out


def minmax_per_trial(arr: np.ndarray) -> np.ndarray:
    """Min-max normalize each leading-axis slice to [0, 1]."""
    arr = np.asarray(arr, dtype=np.float64)
    lo = arr.min(axis=tuple(range(1, arr.ndim)), keepdims=True)
    hi = arr.max(axis=tuple(range(1, arr.ndim)), keepdims=True)
    return (arr - lo) / np.clip(hi - lo, 1e-12, None)
