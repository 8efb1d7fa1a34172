"""Cross-modality comparison figures from ``<mod>_result.npy`` artifacts.

Counterpart of ``video_spike_tpu/viz/raster.py`` (reference
``plot_raster.py:37-271``, ``plot_scatter.py:7-82``):

- per-neuron R² and co-bps scatter between two modalities with a diagonal
  reference line and population metrics in the title;
- trial-sorted raster grids (GT vs predictions per modality) for the top-R²
  neurons, with trials grouped by (choice, block) and a colored group bar.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from video_spike_torch.ops.metrics import bits_per_spike, r2_score_sklearn_like
from video_spike_torch.viz import pyplot


def neuronwise_r2(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Per-neuron R² over flattened (K*T) samples."""
    return np.array([
        r2_score_sklearn_like(gt[..., i].ravel(), pred[..., i].ravel())
        for i in range(gt.shape[-1])
    ])


def scatter_compare(ref_result: Dict, mod_result: Dict,
                    ref_name: str = "me", mod_name: str = "of",
                    eid: str = ""):
    """R² + bps scatter panels comparing two modalities on one session."""
    plt = pyplot()
    gt = np.asarray(ref_result["gt"])
    ref_pred = np.asarray(ref_result["pred"])
    mod_pred = np.asarray(mod_result["pred"])

    ref_r2_n = neuronwise_r2(gt, ref_pred)
    mod_r2_n = neuronwise_r2(gt, mod_pred)
    ref_bps_n = np.asarray(ref_result.get("co_bps", ref_result.get("bps")))
    mod_bps_n = np.asarray(mod_result.get("co_bps", mod_result.get("bps")))

    fig, (ax_r2, ax_bps) = plt.subplots(1, 2, figsize=(11, 5))
    lo, hi = (min(ref_r2_n.min(), mod_r2_n.min()),
              max(ref_r2_n.max(), mod_r2_n.max()))
    ax_r2.scatter(ref_r2_n, mod_r2_n, s=12)
    ax_r2.plot([lo, hi], [lo, hi], "r--", lw=1.5)
    ax_r2.set_xlabel(f"{ref_name} R2")
    ax_r2.set_ylabel(f"{mod_name} R2")
    ax_r2.set_title(f"EID {eid[:5]} R2: {ref_name} "
                    f"{np.nanmean(ref_r2_n):.3f} vs {mod_name} "
                    f"{np.nanmean(mod_r2_n):.3f}")

    lo, hi = (np.nanmin([ref_bps_n.min(), mod_bps_n.min()]),
              np.nanmax([ref_bps_n.max(), mod_bps_n.max()]))
    ax_bps.scatter(ref_bps_n, mod_bps_n, s=12)
    ax_bps.plot([lo, hi], [lo, hi], "r--", lw=1.5)
    ax_bps.set_xlabel(f"{ref_name} BPS")
    ax_bps.set_ylabel(f"{mod_name} BPS")
    ax_bps.set_title(f"BPS: {ref_name} {np.nanmean(ref_bps_n):.3f} vs "
                     f"{mod_name} {np.nanmean(mod_bps_n):.3f}")
    fig.tight_layout()
    return fig


def raster_grid(gt: np.ndarray, preds: Dict[str, np.ndarray],
                choice: Optional[np.ndarray] = None,
                block: Optional[np.ndarray] = None,
                n_neurons: int = 10, eid: str = ""):
    """Trial-sorted rasters: GT + each modality's prediction for the
    top-R² neurons, trials grouped by (choice, block)."""
    plt = pyplot()
    first_pred = next(iter(preds.values()))
    r2_n = neuronwise_r2(gt, first_pred)
    top = np.argsort(r2_n)[::-1][:n_neurons]

    if choice is not None and block is not None:
        groups: List[np.ndarray] = []
        labels = []
        for c in np.unique(choice):
            for b in np.unique(block):
                idx = np.where((choice == c) & (block == b))[0]
                if len(idx):
                    groups.append(idx)
                    labels.append(f"C:{c:.0f}, B:{b:.1f}")
        order = np.concatenate(groups)
        bounds = np.cumsum([0] + [len(g) for g in groups])
    else:
        order = np.arange(gt.shape[0])
        bounds, labels = None, None

    ncols = 1 + len(preds)
    fig, axes = plt.subplots(len(top), ncols,
                             figsize=(3.2 * ncols, 2.2 * len(top)),
                             squeeze=False)
    cmap = plt.get_cmap("tab20")
    for r, n_i in enumerate(top):
        panels = [("GT", gt[order][..., n_i])] + \
                 [(name, p[order][..., n_i]) for name, p in preds.items()]
        for c, (name, mat) in enumerate(panels):
            ax = axes[r][c]
            ax.imshow(mat, aspect="auto", cmap="binary")
            if r == 0:
                ax.set_title(name)
            if c == 0:
                ax.set_ylabel(f"n{n_i}\nR2 {r2_n[n_i]:.2f}", fontsize=8)
            ax.set_xticks([])
            ax.set_yticks([])
            if bounds is not None:
                for gi in range(len(labels)):
                    ax.plot([0, 0], [bounds[gi], bounds[gi + 1]],
                            color=cmap(gi % 20), lw=4)
    fig.suptitle(f"EID {eid[:5]} trial-sorted rasters")
    fig.tight_layout()
    return fig


def population_bps(result: Dict) -> float:
    return float(bits_per_spike(np.asarray(result["pred"]),
                                np.asarray(result["gt"])))
