"""Evaluation metrics: Poisson negative log-likelihood, bits-per-spike, R².

Behavioral parity with the reference's ``src/utils/metric_utils.py:36-102``
and the dispatching ``metrics_list`` in ``src/utils/utils.py:122-181``;
counterpart of ``video_spike_tpu/ops/metrics.py``.

Two tiers:

- numpy reference implementations (golden / small-scale, identical math), and
- torch versions that compute *all neurons at once* on the tensor's device
  (the trainer's eval path), in place of the JAX package's jitted ones.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gammaln as _np_gammaln

LOG2 = float(np.log(2.0))


# ---------------------------------------------------------------------------
# numpy golden paths (exact reference math)
# ---------------------------------------------------------------------------

def neg_log_likelihood(rates, spikes, zero_warning: bool = True) -> float:
    """Total Poisson NLL of `spikes` under `rates`:
    sum(r - n log r + log n!). NaN spikes are masked out; zero rates are
    clamped to 1e-9 (``metric_utils.py:36-76``)."""
    rates = np.asarray(rates, dtype=np.float64)
    spikes = np.asarray(spikes, dtype=np.float64)
    assert rates.shape == spikes.shape, (
        f"rates {rates.shape} vs spikes {spikes.shape}")
    if np.any(np.isnan(spikes)):
        mask = np.isnan(spikes)
        rates = rates[~mask]
        spikes = spikes[~mask]
    assert not np.any(np.isnan(rates)), "NaN rate predictions found"
    assert np.all(rates >= 0), "negative rate predictions found"
    rates = np.where(rates == 0, 1e-9, rates)
    result = rates - spikes * np.log(rates) + _np_gammaln(spikes + 1.0)
    return float(np.sum(result))


def bits_per_spike(rates, spikes) -> float:
    """Bits/spike of `rates` vs the per-neuron mean-rate null model
    (``metric_utils.py:78-102``). Last axis is the neuron axis."""
    spikes = np.asarray(spikes, dtype=np.float64)
    rates = np.asarray(rates, dtype=np.float64)
    nll_model = neg_log_likelihood(rates, spikes)
    null_rates = np.tile(
        np.nanmean(spikes, axis=tuple(range(spikes.ndim - 1)), keepdims=True),
        spikes.shape[:-1] + (1,),
    )
    nll_null = neg_log_likelihood(null_rates, spikes, zero_warning=False)
    return float((nll_null - nll_model) / np.nansum(spikes) / LOG2)


def r2_score_sklearn_like(y_true, y_pred) -> float:
    """R² with sklearn's multioutput='uniform_average' semantics, including
    the zero-variance conventions (sst==0 & ssr==0 -> 1, sst==0 & ssr>0 -> 0).
    y_true/y_pred: (n_samples,) or (n_samples, n_outputs)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if y_true.ndim == 1:
        y_true = y_true[:, None]
        y_pred = y_pred[:, None]
    ssr = np.sum((y_true - y_pred) ** 2, axis=0)
    sst = np.sum((y_true - y_true.mean(axis=0)) ** 2, axis=0)
    scores = np.ones(y_true.shape[1])
    valid = (sst != 0)
    scores[valid] = 1.0 - ssr[valid] / sst[valid]
    scores[(~valid) & (ssr != 0)] = 0.0
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# torch device paths: all neurons in one pass
# ---------------------------------------------------------------------------

def _poisson_nll_per_neuron(rates: torch.Tensor,
                            spikes: torch.Tensor) -> torch.Tensor:
    """Sum over (K, T) of the Poisson NLL per neuron. rates/spikes: (K, T, N)."""
    rates = torch.where(rates == 0, torch.full_like(rates, 1e-9), rates)
    nll = rates - spikes * torch.log(rates) + torch.lgamma(spikes + 1.0)
    return nll.sum(dim=(0, 1))


def bits_per_spike_per_neuron(rates: torch.Tensor,
                              spikes: torch.Tensor) -> torch.Tensor:
    """Per-neuron bits/spike in one reduction. rates/spikes: (K, T, N) float;
    returns (N,) float32. Matches looping the reference `bits_per_spike` over
    single-neuron slices; neurons with zero spikes come out ±inf, which
    callers convert to NaN exactly like the reference does."""
    rates = rates.float()
    spikes = spikes.float()
    nll_model = _poisson_nll_per_neuron(rates, spikes)
    null_rates = spikes.mean(dim=(0, 1), keepdim=True).expand_as(spikes)
    nll_null = _poisson_nll_per_neuron(null_rates, spikes)
    return (nll_null - nll_model) / spikes.sum(dim=(0, 1)) / LOG2


def r2_per_column(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Vectorized sklearn-style R² over dim -2 (samples) for every output
    column; leading dims are batch. y: (..., n_samples, n_outputs)."""
    ssr = ((y_true - y_pred) ** 2).sum(dim=-2)
    mean = y_true.mean(dim=-2, keepdim=True)
    sst = ((y_true - mean) ** 2).sum(dim=-2)
    r2 = 1.0 - ssr / torch.where(sst == 0, torch.ones_like(sst), sst)
    zero_var = torch.where(ssr == 0, torch.ones_like(ssr),
                           torch.zeros_like(ssr))
    return torch.where(sst == 0, zero_var, r2)


def device_eval_metrics(log_rates: torch.Tensor, gt: torch.Tensor):
    """(bps, rsquared) as 0-d tensors on the input's device for one session,
    matching ``metrics_list``'s host semantics for the ("bps", "rsquared")
    pair: per-neuron bits/spike with inf -> NaN, nanmeaned; per-trial
    sklearn-style R² of the (N, T) plane (samples=neurons, outputs=bins),
    nanmeaned over trials. ``log_rates``/``gt``: (K, T, N)."""
    preds = torch.exp(log_rates.float())
    gt = gt.float()
    bps_n = bits_per_spike_per_neuron(preds, gt)
    bps_n = torch.where(torch.isinf(bps_n), torch.full_like(bps_n, float("nan")),
                        bps_n)
    # per trial k: samples are the N neurons, outputs the T bins
    r2_t = r2_per_column(gt.transpose(1, 2), preds.transpose(1, 2)).mean(dim=-1)
    return torch.nanmean(bps_n), torch.nanmean(r2_t)


# ---------------------------------------------------------------------------
# metrics_list — the trainer-facing dispatcher
# ---------------------------------------------------------------------------

def _swap_first_last(a: np.ndarray) -> np.ndarray:
    """Equivalent of torch.transpose(a, -1, 0)."""
    return np.swapaxes(a, 0, -1)


def metrics_list(gt, pred, metrics=("bps", "rsquared"), use_device: bool = True):
    """Multi-metric dispatcher with the reference's exact conventions
    (reference ``src/utils/utils.py:122-181``).

    `gt`/`pred` arrive already swapped to (N, T, K) by the trainer (the
    reference calls ``.transpose(-1, 0)`` before passing in); internally:

    - "bps": swaps back to (K, T, N) and computes per-neuron bits/spike
      (inf -> NaN), reporting the nanmean.
    - "rsquared": per-trial sklearn R² over the (N, T) slice of each trial,
      nanmean across trials.
    - "mse"/"mae": plain means.
    """
    gt = np.asarray(gt, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    results = {}

    if "bps" in metrics:
        _gt = _swap_first_last(gt)     # (K, T, N)
        _pred = _swap_first_last(pred)
        if use_device:
            bps = bits_per_spike_per_neuron(
                torch.from_numpy(_pred), torch.from_numpy(_gt)).numpy()
            bps = np.where(np.isinf(bps), np.nan, bps)
        else:
            bps = np.array([
                bits_per_spike(_pred[:, :, [i]], _gt[:, :, [i]])
                for i in range(_gt.shape[-1])
            ])
            bps = np.where(np.isinf(bps), np.nan, bps)
        results["bps"] = float(np.nanmean(bps))

    if "rsquared" in metrics:
        # gt here is (N, T, K); the reference loops i over the last (trial)
        # axis and scores the (N, T) plane with sklearn's uniform_average.
        r2_list = [
            r2_score_sklearn_like(gt[:, :, i], pred[:, :, i])
            for i in range(gt.shape[-1])
        ]
        results["rsquared"] = float(np.nanmean(r2_list))

    if "r2" in metrics:
        # per-sample-loop variant kept for parity with the reference's "r2"
        r2_list = []
        for i in range(gt.shape[0]):
            per_row = [r2_score_sklearn_like(gt[i].T[k], pred[i].T[k])
                       for k in range(gt[i].T.shape[0])]
            r2_list.append(float(np.ma.masked_invalid(per_row).mean()))
        results["r2"] = float(np.mean(r2_list))

    if "behave_r2" in metrics:
        _gt, _pred = _swap_first_last(gt), _swap_first_last(pred)
        r2s = [r2_score_sklearn_like(_gt[i].ravel(), _pred[i].ravel())
               for i in range(_gt.shape[0])]
        results["behave_r2"] = float(np.nanmean(r2s))

    if "mse" in metrics:
        results["mse"] = float(np.mean((gt - pred) ** 2))

    if "mae" in metrics:
        results["mae"] = float(np.mean(np.abs(gt - pred)))

    if "acc" in metrics:
        results["acc"] = float(np.mean(gt == pred))

    return results


def topk(similarities: np.ndarray, labels: np.ndarray, k: int = 5) -> float:
    """Fraction of rows whose label is within the top-k most-similar columns
    (``metric_utils.py:17-24``)."""
    k = min(k, similarities.shape[0])
    order = np.argsort(similarities, axis=1)
    total = 0.0
    for i in range(k):
        total += np.sum(order[:, -(i + 1)] == labels) / len(labels)
    return float(total)
