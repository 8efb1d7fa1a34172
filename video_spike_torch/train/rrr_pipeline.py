"""End-to-end RRR fit + co-bps/R² evaluation on feature/label dicts.

Counterpart of ``video_spike_tpu/train/rrr_pipeline.py`` (reference
``train_rrr``, ``src/utils/utils.py:376-456``; also nested inside SSL
validation, ``src/trainer/contrast.py:129-162``):

1. standardize X and y by train-split stats (std clipped at 1e-8),
2. append a bias column of ones to X,
3. fit RRR (l2=100, ncomp=3) per session — closed-form ALS
   (``models/rrr.py``),
4. predict the held-out split, un-standardize, clip rates at 1e-3,
5. per-neuron bits-per-spike and per-trial R² against the *unsmoothed*
   ground truth stored before standardization.

The metrics run on ``device`` over all neurons (and, for R², all trials) in
one reduction each (``ops/metrics.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from video_spike_torch.models.rrr import train_model_main
from video_spike_torch.ops.metrics import bits_per_spike_per_neuron, r2_per_column
from video_spike_torch.ops.signal import standardize


def prepare_rrr_data(data_dict: Dict) -> Dict:
    """Standardize X/y in place by train stats and append the bias column.
    Stores per-session mean/std under ``setup`` and returns the raw held-out
    ground truth per eid."""
    ground_truth = {}
    for eid in data_dict:
        _, mean_X, std_X = standardize(data_dict[eid]["X"][0])
        _, mean_y, std_y = standardize(data_dict[eid]["y"][0])
        ground_truth[eid] = np.array(data_dict[eid]["y"][1], copy=True)
        for i in range(2):
            X = np.asarray(data_dict[eid]["X"][i], dtype=np.float64)
            X = (X - mean_X) / std_X
            if X.ndim == 2:
                X = X[..., None]
            K, T = X.shape[:2]
            X = np.concatenate([X, np.ones((K, T, 1))], axis=2)
            data_dict[eid]["X"][i] = X
            y = np.asarray(data_dict[eid]["y"][i], dtype=np.float64)
            data_dict[eid]["y"][i] = (y - mean_y) / std_y
        data_dict[eid]["setup"]["mean_X_Tv"] = mean_X
        data_dict[eid]["setup"]["std_X_Tv"] = std_X
        data_dict[eid]["setup"]["mean_y_TN"] = mean_y
        data_dict[eid]["setup"]["std_y_TN"] = std_y
    return ground_truth


def eval_rrr_predictions(pred, gt_held_out: np.ndarray,
                         threshold: float = 1e-3, device="cpu") -> Dict:
    """Per-neuron co-bps + per-trial-averaged R². ``pred`` and
    ``gt_held_out`` are (K, T, N); the metrics run in float32 on
    `device`."""
    if isinstance(pred, torch.Tensor):
        pred = pred.detach().cpu().numpy()
    pred = np.clip(np.asarray(pred, dtype=np.float64), threshold, None)
    pred_t = torch.as_tensor(pred, dtype=torch.float32, device=device)
    gt_t = torch.as_tensor(np.asarray(gt_held_out), dtype=torch.float32,
                           device=device)
    bps = bits_per_spike_per_neuron(pred_t, gt_t).cpu().numpy()
    bps = np.where(np.isinf(bps), np.nan, bps)
    # per-neuron R²: mean over trials k of r2(gt[k, :, n], pred[k, :, n])
    r2_trials = r2_per_column(gt_t, pred_t).cpu().numpy()    # (K, N)
    r2 = np.nanmean(r2_trials, axis=0)
    return {"bps": bps.tolist(), "r2": r2.tolist(), "pred": pred}


def train_rrr(data_dict: Dict, l2: float = 100.0, n_comp: int = 3,
              max_iter: int = 120, verbose: bool = False,
              device="cuda") -> Dict:
    """Standardize, fit per session, evaluate held-out co-bps/R²."""
    ground_truth = prepare_rrr_data(data_dict)
    result = {}
    for eid in data_dict:
        model, _ = train_model_main(
            train_data={eid: data_dict[eid]}, l2=l2, n_comp=n_comp,
            model_fname="tmp", save=False, max_iter=max_iter, device=device)
        _, _, pred = model.predict_y_fr(data_dict, eid, 1)
        ev = eval_rrr_predictions(pred, ground_truth[eid], device=model.device)
        if verbose:
            print(f"{eid}: co-bps={np.nanmean(ev['bps']):.5f} "
                  f"r2={np.nanmean(ev['r2']):.5f}")
        result[eid] = {
            "gt": ground_truth[eid],
            "pred": ev["pred"],
            "bps": ev["bps"],
            "r2": ev["r2"],
            "eid": eid,
        }
    return result
