"""Plotting: gt-vs-pred rasters, per-neuron R² traces, result boxplots.

Counterpart of ``video_spike_tpu/viz/plots.py`` (reference
``src/utils/utils.py:68-105,205-224``): ``plot_gt_pred`` and
``plot_neurons_r2`` are the trainers' ``save_plot`` figures,
``draw_results_boxplot`` is ``cli/visualize_result.py``'s.
"""

from __future__ import annotations

import numpy as np

from video_spike_torch.ops.metrics import r2_score_sklearn_like
from video_spike_torch.viz import pyplot


def plot_gt_pred(gt: np.ndarray, pred: np.ndarray, epoch=0,
                 modality: str = "ap"):
    """Side-by-side ground-truth / prediction heatmaps (neurons x time)."""
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    im1 = ax1.imshow(gt, aspect="auto", cmap="binary")
    ax1.set_title("Ground Truth")
    im2 = ax2.imshow(pred, aspect="auto", cmap="binary")
    ax2.set_title("Prediction")
    plt.colorbar(im1, ax=ax1)
    plt.colorbar(im2, ax=ax2)
    fig.suptitle(f"Epoch: {epoch}, Mod: {modality}")
    return fig


def plot_neurons_r2(gt: np.ndarray, pred: np.ndarray, neuron_idx=(),
                    epoch=0, modality: str = "ap"):
    """Per-neuron trial-averaged traces with R² in each panel title."""
    plt = pyplot()
    neuron_idx = list(neuron_idx)
    fig, axes = plt.subplots(len(neuron_idx), 1,
                             figsize=(12, 5 * max(len(neuron_idx), 1)))
    if len(neuron_idx) == 1:
        axes = [axes]
    r2s = []
    for ax, n in zip(axes, neuron_idx):
        r2 = r2_score_sklearn_like(gt[:, n], pred[:, n])
        r2s.append(r2)
        ax.plot(gt[:, n], label="Ground Truth", color="blue")
        ax.plot(pred[:, n], label="Prediction", color="red")
        ax.set_title(f"Neuron: {n}, R2: {r2:.4f}")
        ax.set_xlabel("Time")
        ax.set_ylabel("Rate")
        ax.legend()
    fig.suptitle(f"Epoch: {epoch}, Mod: {modality}, "
                 f"Avg R2: {np.mean(r2s):.4f}")
    return fig


def draw_results_boxplot(df, metric: str = "test_bps"):
    """Boxplot + mean bar of a metric grouped by input modality. ``df`` is
    a pandas frame with columns [metric, 'eid', 'mod']."""
    plt = pyplot()
    fig, ax = plt.subplots(1, 1, figsize=(12, 5))
    groups = list(df.groupby("mod"))
    for i, (mod, g) in enumerate(groups):
        vals = np.asarray(g[metric].values, dtype=float)
        ax.boxplot(vals, positions=[i], widths=0.2,
                   medianprops=dict(color="black"))
        ax.bar(i, np.nanmean(vals), width=0.3, alpha=0.6)
        ax.text(i, np.nanmean(vals), f"{np.nanmean(vals):.2f}",
                ha="center", va="bottom")
    ax.set_xticks(range(len(groups)))
    ax.set_xticklabels([m for m, _ in groups])
    ax.set_ylabel(metric.replace("test_", ""))
    return fig
